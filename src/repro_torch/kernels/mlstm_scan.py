"""Chunkwise mLSTM on Hopper: wrapper of the CUDA kernel in
``csrc/mlstm_scan.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.mlstm_scan.mlstm_scan``
(``src/repro/kernels/mlstm_scan.py:73``): per (batch, head) the gated linear
attention ``C_t = f_t C_{t-1} + i_t k_t v_tᵀ``, ``y_t = (q_t/√hd) C_t``,
computed chunk by chunk with the decays in log space.  A prefill chunk is
bound by operations, a one-token decode step by the bytes of the state; the
design notes are in the CUDA source.

This wrapper launches the kernel or raises; it never computes on the CPU.
``repro_torch.kernels.ops`` sends CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "mlstm_scan"
DEFAULT_CHUNK = 128     # the TPU kernel's default
MAX_CHUNK = 128         # rows of the score tile held in shared memory
MAX_HD = 448            # the state slab, score tile and V slab fill 227 KB
DTYPES = (torch.float32, torch.bfloat16)

launches = 0        # kernel launches since the last reset (see ops)
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load(NAME).mlstm_scan_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, i_gate, f_gate, c0, out, chunk):
    ts = (q, k, v, i_gate, f_gate, c0) + (() if out is None else (out,))
    if not all(t.is_cuda for t in ts):
        raise ValueError("mlstm_scan kernel needs CUDA tensors; got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError("all inputs must be on one device")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype
                                    for t in (k, v, i_gate, f_gate)):
        raise ValueError(f"dtypes of q, k, v, i, f must match and be fp32 or "
                         f"bf16: {[t.dtype for t in ts[:5]]}")
    if c0.dtype != torch.float32 or (out is not None
                                     and out.dtype != torch.float32):
        raise ValueError("c0 and out must be fp32")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if i_gate.shape != (B, S, H) or f_gate.shape != (B, S, H):
        raise ValueError(f"gates must be {(B, S, H)}: i{tuple(i_gate.shape)}"
                         f" f{tuple(f_gate.shape)}")
    state = (B, H, hd, hd)
    if c0.shape != state or (out is not None and out.shape != state):
        raise ValueError(f"c0 and out must be {state}")
    if S < 1 or hd % 16 or not 16 <= hd <= MAX_HD:
        raise ValueError(f"need S >= 1 and head_dim a multiple of 16 in "
                         f"[16, {MAX_HD}]: S {S}, head_dim {hd}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside [1, {MAX_CHUNK}]")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("last dim of q, k, v must be contiguous (stride 1)")
    if not c0.is_contiguous() or (out is not None
                                  and not out.is_contiguous()):
        raise ValueError("c0 and out must be contiguous")


def mlstm_scan(q, k, v, i_gate, f_gate, c0, *, chunk=DEFAULT_CHUNK,
               out=None):
    """q,k,v: (B,S,H,hd)  i,f: (B,S,H) in (0,1)  c0: (B,H,hd,hd) fp32.

    Returns (y (B,S,H,hd) in q's dtype, c_last (B,H,hd,hd) fp32), as the
    TPU kernel does.  q, k, v and the gates may have any strides with a unit
    last dim.  ``out`` (fp32, contiguous) receives c_last and may be ``c0``
    itself: the decode step then updates the cache in place.
    """
    global launches
    chunk = min(int(chunk), q.shape[1])
    _check(q, k, v, i_gate, f_gate, c0, out, chunk)
    B, S, H, hd = q.shape
    y = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if out is None:
        out = torch.empty_like(c0)
    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *i_gate.stride(), *f_gate.stride(), *y.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), i_gate.data_ptr(), f_gate.data_ptr(),
            c0.data_ptr(), y.data_ptr(), out.data_ptr(), B, S, H, hd, chunk,
            strides, stream)
    if err != 0:
        raise RuntimeError(f"mlstm_scan launch failed: CUDA error {err}")
    launches += 1
    return y, out
