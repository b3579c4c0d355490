"""The least work of one ``flash_decode`` call (one query token a request
against the cache): q read and the output written once, K and V read up
to ``kv_len``, and 4 hd flops a (query, key) pair."""
from __future__ import annotations

from perfbench import registry

# The program's kernel: csrc/flash_decode.cu's entry, by name.
KERNEL = r"\bdecode_kernel\b"


def bound(B, Hq, Hkv, T, hd, kv_len, *, itemsize=2, dtype="bfloat16"):
    """(bound ms, "bytes" or "operations", bytes, flops); T, the cache's
    length, is read only up to ``kv_len``."""
    return registry.module("counts", "flash_attention").bound(
        B, Hq, Hkv, 1, T, hd, causal=False, kv_len=kv_len,
        itemsize=itemsize, dtype=dtype)
