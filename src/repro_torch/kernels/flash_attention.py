"""Flash attention on Hopper: wrapper of the CUDA kernel in
``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention.
flash_attention`` (``src/repro/kernels/flash_attention.py:85``) with the same
contract: causal with ``q_offset``, sliding window, optional ``kv_len``,
tanh softcap, GQA, and any head dim up to ``MAX_HD`` (``takes``).  The
kernel is bound by operations (prefill is quadratic in the sequence).  bf16
runs both products on the tensor cores (``wgmma``, K/V streamed by
``cp.async`` through a 2-stage ring), fp32 on the CUDA cores; both pad the
head dim in shared memory, never in a copy of Q, K or V.  The design notes
are in the CUDA source.

This wrapper launches the kernel or raises; it never computes on the CPU.
``repro_torch.kernels.ops`` sends CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, refuse_grad

NAME = "flash_attention"
MAX_HD = 512        # the widest head dim either kernel takes
DTYPES = (torch.float32, torch.bfloat16)
# Padded widths instantiated in the CUDA source, as wgmma_width and
# fp32_width there pick them: a head dim runs at the first width >= hd.
WGMMA_WIDTHS = (16, 32, 64, 128, 192, 256, 384, 512)   # bf16, on wgmma
FP32_WIDTHS = (16, 32, 64, 112, 128, 256, 512)          # fp32, CUDA cores

BLOCK_Q = 64        # query rows per block (one warpgroup in bf16)
BLOCK_KV = 32       # keys per K/V tile of the bf16 kernel

launches = 0        # kernel launches since the last reset (see ops)
_fn = None


def takes(hd: int, dtype) -> Optional[str]:
    """None if the kernels take head dim ``hd`` in ``dtype``, else why not.
    The one place the contract's limits live: ``_check`` raises with it."""
    if dtype not in DTYPES:
        return f"dtype {dtype} is not fp32 or bf16"
    if not 1 <= hd <= MAX_HD:
        return f"head_dim {hd} outside [1, MAX_HD = {MAX_HD}]"
    return None


def _first_at_least(widths, hd: int) -> int:
    return next(w for w in widths if hd <= w)


def wgmma_width(hd: int) -> int:
    """Padded width of the bf16 kernel's tile rows, as the CUDA source's
    ``wgmma_width``: 16, 32 or 64 up to hd 64 (32-, 64- or 128-byte
    swizzled rows), then whole 128-byte column blocks (hd 80, 96 and 112
    run at 128, hd 160 at 192); the padding is zeros."""
    return _first_at_least(WGMMA_WIDTHS, hd)


def fp32_width(hd: int) -> int:
    """Padded width of the fp32 kernel (``fp32_width`` in the source)."""
    return _first_at_least(FP32_WIDTHS, hd)


def out_width(hp: int) -> int:
    """Output columns one bf16 block keeps at padded width ``hp``: all of
    them up to 256, half above (two blocks split a row of O)."""
    return hp if hp <= 256 else hp // 2


def wgmma_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of the bf16 kernel at head dim ``hd``, as the
    CUDA source's ``wgmma_smem_bytes`` reckons it: the Q tile and two stages
    of K tiles in bf16 at ``wgmma_width(hd)``, two stages of V tiles at the
    block's ``out_width``, and 1024 bytes to align the swizzled tiles."""
    hp = wgmma_width(hd)
    ow = out_width(hp)
    return (BLOCK_Q * hp + 2 * BLOCK_KV * hp + 2 * BLOCK_KV * ow) * 2 + 1024


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
    why = takes(hd, q.dtype)
    if why:
        raise ValueError(why)
    if Sq < 1 or k.shape[2] < 1:
        raise ValueError("empty sequence")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("last dim must be contiguous (stride 1)")
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
