"""The least work of one ``flash_attention`` call (a causal prefill):
each input read once (of K and V, the keys some query can see), the output
written once, and 4 hd flops (the multiply-adds of QK^T and PV) per
visible (query, key) pair."""
from __future__ import annotations

from perfbench import registry

# The program's kernel: csrc/flash_attention.cu's entries, by name.
KERNEL = r"\battn(_wgmma)?_kernel\b"


def bound(B, Hq, Hkv, Sq, Skv, hd, *, causal=True, q_offset=0, kv_len=None,
          window=0, itemsize=2, dtype="bfloat16"):
    """(bound ms, "bytes" or "operations", bytes, flops)."""
    valid = min(Skv, Skv if kv_len is None else kv_len)
    if causal:
        def span(pos):
            lo = max(0, pos - window + 1) if window > 0 else 0
            return lo, min(valid, pos + 1)
        first, last = span(q_offset), span(q_offset + Sq - 1)
        if window > 0:
            pairs = sum(max(0, hi - lo) for lo, hi in
                        (span(q + q_offset) for q in range(Sq)))
        else:       # rows q_offset .. q_offset+Sq-1 see min(valid, p+1) keys
            pairs = sum(min(valid, q + q_offset + 1) for q in range(Sq)) \
                if q_offset + Sq > valid else \
                Sq * (2 * q_offset + Sq + 1) // 2
        seen = max(0, last[1] - first[0])
    else:
        pairs, seen = Sq * valid, valid
    nbytes = itemsize * (2 * B * Hq * Sq * hd + 2 * B * Hkv * seen * hd)
    flops = 4.0 * B * Hq * hd * pairs
    ms, by = registry.module("counts", "_peaks").least_ms(flops, nbytes, dtype)
    return ms, by, nbytes, flops
