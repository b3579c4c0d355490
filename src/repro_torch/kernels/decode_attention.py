"""Flash decode on Hopper: wrapper of the CUDA kernel in
``csrc/flash_decode.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.decode_attention.
flash_decode`` (``src/repro/kernels/decode_attention.py:66``): one query
token per (batch, head) against a preallocated ``(B,Hkv,T,hd)`` cache whose
valid prefix is the scalar ``kv_len``.  The kernel is bound by the K/V bytes
it streams, and at a few hundred keys by its chain of latencies: one launch
per call, the split partials merged by the last block of each (batch, KV
head) to finish.  Its design notes are in the CUDA source.

This wrapper launches the kernel or raises; it never computes on the CPU.
``repro_torch.kernels.ops`` sends CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build

NAME = "flash_decode"
BLOCK_KV = 32           # keys per tile in the kernel
STAGES = 2              # tiles in flight per block
MAX_GROUP_HD = 2048     # g * hd held in the kernel's registers
MAX_HD = 256
DTYPES = (torch.float32, torch.bfloat16)
TARGET_BLOCKS = 2 * 132  # two blocks for each SM of an H100

launches = 0        # kernel launches since the last reset (see ops)
_fn = None
# The merge's int32 ticket counters, one tensor per (device index, stream):
# a call leaves them zeroed, and calls on one stream run in stream order.
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load(NAME).flash_decode_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def split_plan(batch: int, kv_heads: int, kv_len: int):
    """(n_split, tiles_per_split): split the valid KV tiles so that the grid
    has about ``TARGET_BLOCKS`` blocks, every split holding at least one.
    Each block's chain is one trip to memory for its (at most ``STAGES`` at
    the serving shapes) tiles, so more, shorter splits cost only the merge's
    reads of their partials."""
    n_tiles = -(-kv_len // BLOCK_KV)
    want = max(1, min(n_tiles, -(-TARGET_BLOCKS // (batch * kv_heads))))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def smem_bytes(group: int, hd: int, itemsize: int) -> int:
    """Dynamic shared memory of one block, as the CUDA source's
    ``smem_bytes`` reckons it: ``STAGES`` K and V tiles in the input dtype
    with 16 bytes of pad a row, then fp32 q, the tile's probabilities and
    three floats of row state per query row."""
    return (STAGES * 2 * BLOCK_KV * (hd * itemsize + 16)
            + 4 * (group * hd + group * BLOCK_KV + 3 * group))


def _tickets_for(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The ticket counters of one (device, stream), at least ``n`` long."""
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def _check(q, k, v, kv_len):
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes must match and be fp32 or bf16: "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape[2] != 1 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, Hq, _, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Hq % Hkv:
        raise ValueError(f"q{tuple(q.shape)} does not fit k{tuple(k.shape)}")
    if hd > MAX_HD or (Hq // Hkv) * hd > MAX_GROUP_HD:
        raise ValueError(f"head_dim {hd} with group {Hq // Hkv} is too wide")
    if not 1 <= kv_len <= T:
        raise ValueError(f"kv_len {kv_len} outside [1, {T}]")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("last dim must be contiguous (stride 1)")
    # The kernel reads K/V rows in 16-byte vectors.
    item = k.element_size()
    for t in (k, v):
        if t.data_ptr() % 16 or any(s * item % 16 for s in t.stride()[:3]) \
                or hd * item % 16:
            raise ValueError("K/V rows must be 16-byte aligned")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_decode kernel needs CUDA tensors; "
                         f"got {q.device}, {k.device}, {v.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def flash_decode(q, k, v, kv_len: int, *, softcap=0.0):
    """q: (B,Hq,1,hd)  k,v: (B,Hkv,T,hd)  kv_len: int -> (B,Hq,1,hd).

    Strides of the B, H and T dims are passed to the kernel, so the model
    hands in ``transpose(1, 2)`` views of its ``(B,T,Nkv,hd)`` cache.
    """
    global launches
    kv_len = int(kv_len)
    _check(q, k, v, kv_len)
    B, Hq, _, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    n_split, per = split_plan(B, Hkv, kv_len)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        part_acc = part_ml = tickets = None
        if n_split > 1:
            part_acc = torch.empty((B * Hq, n_split, hd), dtype=torch.float32,
                                   device=q.device)
            part_ml = torch.empty((B * Hq, n_split, 2), dtype=torch.float32,
                                  device=q.device)
            tickets = _tickets_for(q.device, stream, B * Hkv)
        err = _launcher()(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (part_acc, part_ml, tickets)),
            B, Hq, Hkv, T, hd, strides, kv_len, float(softcap), n_split, per,
            stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    launches += 1
    return out
