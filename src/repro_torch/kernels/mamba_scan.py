"""Selective scan (Mamba) on Hopper: wrapper of the CUDA kernel in
``csrc/mamba_scan.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.mamba_scan.mamba_scan``
(``src/repro/kernels/mamba_scan.py:55``): per batch row and channel the
recurrence ``h_t = exp(dt_t·a) ⊙ h_{t-1} + (dt_t·b_t)·u_t``,
``y_t = h_t · c_t``, carrying the fp32 state across the whole sequence.
The kernel is bound by the bytes of u, dt, y and the state and by the
special-function units' exps, which take about the same time; its design
notes are in the CUDA source.

This wrapper launches the kernel or raises; it never computes on the CPU.
``repro_torch.kernels.ops`` sends CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "mamba_scan"
STATE_SIZES = (4, 8, 16)      # N, instantiated in the CUDA source
CHANNELS = 64                 # channels per block: di must be a multiple
DTYPES = (torch.float32, torch.bfloat16)

STEPS = 16                    # time steps of a staged chunk (prefill)
STAGES = 3                    # chunks in the prefill's cp.async ring

launches = 0        # kernel launches since the last reset (see ops)
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load(NAME).mamba_scan_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def scan_smem_bytes(N: int, itemsize: int) -> int:
    """Dynamic shared memory of the prefill kernel (``scan_smem_bytes`` in
    the CUDA source): STAGES slots of u, dt ([STEPS][CHANNELS]) and b, c
    ([STEPS][N]) in the inputs' dtype, and the fp32 partial y of each of a
    channel's 4 lanes."""
    return STAGES * (2 * STEPS * CHANNELS + 2 * STEPS * N) * itemsize \
        + STEPS * 4 * (CHANNELS + 8) * 4


def _check(u, dt, a, b, c, h0, out):
    ts = (u, dt, a, b, c, h0) + (() if out is None else (out,))
    if not all(t.is_cuda for t in ts):
        raise ValueError("mamba_scan kernel needs CUDA tensors; got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.device != u.device for t in ts):
        raise ValueError("all inputs must be on one device")
    if u.dtype not in DTYPES or any(t.dtype != u.dtype for t in (dt, b, c)):
        raise ValueError(f"dtypes of u, dt, b, c must match and be fp32 or "
                         f"bf16: {[t.dtype for t in (u, dt, b, c)]}")
    if any(t.dtype != torch.float32 for t in ts[5:] + (a,)):
        raise ValueError("a, h0 and out must be fp32")
    if u.dim() != 3 or dt.shape != u.shape:
        raise ValueError(f"bad shapes u{tuple(u.shape)} dt{tuple(dt.shape)}")
    B, S, di = u.shape
    N = a.shape[-1]
    if a.shape != (di, N) or b.shape != (B, S, N) or c.shape != (B, S, N):
        raise ValueError(f"a{tuple(a.shape)} b{tuple(b.shape)} "
                         f"c{tuple(c.shape)} do not fit u{tuple(u.shape)}")
    if h0.shape != (B, di, N) or (out is not None and out.shape != h0.shape):
        raise ValueError(f"h0 and out must be {(B, di, N)}")
    if S < 1 or N not in STATE_SIZES:
        raise ValueError(f"need S >= 1 and a state size in {STATE_SIZES}: "
                         f"S {S}, N {N}")
    if di % CHANNELS:
        raise ValueError(f"di {di} must be a multiple of {CHANNELS}")
    if any(t.stride(-1) != 1 for t in (u, dt, b, c)):
        raise ValueError("last dim of u, dt, b, c must be contiguous "
                         "(stride 1)")
    # The prefill copies rows of u and dt in 16-byte and of b and c in
    # 4-byte pieces (cp.async); the state and a are read as vectors.
    for t, align in ((u, 16), (dt, 16), (b, 4), (c, 4)):
        if t.data_ptr() % align or any(s * t.element_size() % align
                                       for s in t.stride()[:2]):
            raise ValueError("u and dt must be 16-byte and b, c 4-byte "
                             "aligned (pointer and batch/seq strides)")
    if not all(t.is_contiguous() for t in ts[5:] + (a,)):
        raise ValueError("a, h0 and out must be contiguous")
    if any(t.data_ptr() % 16 for t in ts[5:] + (a,)):
        raise ValueError("a, h0 and out must be 16-byte aligned")


def mamba_scan(u, dt, a, b, c, h0, *, out=None):
    """u,dt: (B,S,di)  a: (di,N) fp32  b,c: (B,S,N)  h0: (B,di,N) fp32.

    Returns (y (B,S,di) in u's dtype, h_last (B,di,N) fp32), as the TPU
    kernel does.  u, dt, b and c may have any batch and sequence strides
    with a unit last dim (16-byte aligned for u and dt, 4-byte for b and
    c); di must be a multiple of 64.  ``out`` (fp32, contiguous) receives
    h_last and may be ``h0`` itself: the decode step then updates the
    cache in place.
    """
    global launches
    _check(u, dt, a, b, c, h0, out)
    B, S, di = u.shape
    y = torch.empty((B, S, di), dtype=u.dtype, device=u.device)
    if out is None:
        out = torch.empty_like(h0)
    strides = (ctypes.c_longlong * 8)(
        *u.stride()[:2], *dt.stride()[:2], *b.stride()[:2], *c.stride()[:2])
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(
            int(u.dtype == torch.bfloat16), u.data_ptr(), dt.data_ptr(),
            a.data_ptr(), b.data_ptr(), c.data_ptr(), h0.data_ptr(),
            y.data_ptr(), out.data_ptr(), B, S, di, a.shape[-1], strides,
            stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    launches += 1
    return y, out
