"""Flash attention on Hopper: wrapper of the CUDA kernel in
``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention.
flash_attention`` (``src/repro/kernels/flash_attention.py:85``) with the same
contract: causal with ``q_offset``, sliding window, optional ``kv_len``,
tanh softcap, GQA.  The kernel is bound by operations (prefill is
quadratic in the sequence).  bf16 runs both products on the tensor cores
(``wgmma``, K/V streamed by ``cp.async`` through a 2-stage ring), fp32 on the
CUDA cores; the design notes are in the CUDA source.

This wrapper launches the kernel or raises; it never computes on the CPU.
``repro_torch.kernels.ops`` sends CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, refuse_grad

NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 112, 128, 256)   # instantiated in the CUDA source
DTYPES = (torch.float32, torch.bfloat16)

BLOCK_Q = 64        # query rows per block (one warpgroup in bf16)
BLOCK_KV = 32       # keys per K/V tile of the bf16 kernel

launches = 0        # kernel launches since the last reset (see ops)
_fn = None


def tile_width(hd: int) -> int:
    """Width of the bf16 kernel's tile rows in values, as the CUDA source's
    ``tile_width``: past 64, whole 128-byte column blocks (hd 112 is laid
    out at 128, its last two 16-byte chunks zeros)."""
    return hd if hd <= 64 else -(-hd // 64) * 64


def wgmma_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of the bf16 kernel at head dim ``hd``, as the
    CUDA source's ``wgmma_smem_bytes`` reckons it: the Q tile and two stages
    of K and V tiles, in bf16 at ``tile_width(hd)``, and 1024 bytes to align
    the swizzled tiles."""
    return (BLOCK_Q + 4 * BLOCK_KV) * tile_width(hd) * 2 + 1024


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load(NAME).flash_attention_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v):
    refuse_grad(NAME, q, k, v)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes must match and be fp32 or bf16: "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, Hq, Sq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or Hq % k.shape[1]:
        raise ValueError(f"q{tuple(q.shape)} does not fit k{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if Sq < 1 or k.shape[2] < 1:
        raise ValueError("empty sequence")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("last dim must be contiguous (stride 1)")
    # The bf16 kernel copies Q, K and V rows in 16-byte pieces.
    if q.dtype == torch.bfloat16:
        for t in (q, k, v):
            if t.data_ptr() % 16 or any(st * 2 % 16 for st in t.stride()[:3]):
                raise ValueError("bf16 Q/K/V rows must be 16-byte aligned")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel needs CUDA tensors; "
                         f"got {q.device}, {k.device}, {v.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0, kv_len=None):
    """q: (B,Hq,Sq,hd)  k,v: (B,Hkv,Skv,hd) -> (B,Hq,Sq,hd) in q's dtype.

    Any strides with a unit last dim are taken, so the model passes
    ``(B,S,N,hd)`` tensors as ``transpose(1, 2)`` views without a copy.  The
    output is laid out ``(B,Sq,Hq,hd)`` in memory and returned as the
    ``(B,Hq,Sq,hd)`` view.
    """
    global launches
    _check(q, k, v)
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Skv, hd, strides,
            int(causal), int(window), float(softcap), int(q_offset),
            Skv if kv_len is None else int(kv_len), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out
