"""Chunkwise mLSTM on Hopper: wrapper of the CUDA kernels in
``csrc/mlstm_scan.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.mlstm_scan.mlstm_scan``
(``src/repro/kernels/mlstm_scan.py:73``): per (batch, head) the gated linear
attention ``C_t = f_t C_{t-1} + i_t k_t v_tᵀ``, ``y_t = (q_t/√hd) C_t``,
computed chunk by chunk with the decays in log space.  Beyond the TPU
kernel, it also carries the normalizer ``n_t = f_t n_{t-1} + i_t k_t`` (C's
update with v = 1) when given ``n0``.  A prefill runs on the tensor cores
(3xTF32) and is bound by operations, a one-token decode step by the bytes of
the state; the design notes are in the CUDA source.

This wrapper launches the kernels or raises; it never computes on the CPU.
``repro_torch.kernels.ops`` sends CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, refuse_grad

NAME = "mlstm_scan"
DEFAULT_CHUNK = 128     # the TPU kernel's default
MAX_CHUNK = 128         # rows of the score tile held in shared memory
MAX_HD = 448            # the state slab and the staged tiles fill 227 KB
DTYPES = (torch.float32, torch.bfloat16)

launches = 0        # kernel launches since the last reset (see ops)
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load(NAME).mlstm_scan_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                       + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def scan_smem_bytes(hd: int, et: int) -> int:
    """Dynamic shared memory of the prefill's scan kernel at slab width
    ``et`` (``scan_smem_bytes`` in the CUDA source): the hd x (et + 8) slab
    of C, the chunk's v columns, its scores (128 x 132), the staged q or k
    tile (at most 128 x 72) and the gate and normalizer vectors."""
    lc = et + 8
    return 4 * (hd * lc + MAX_CHUNK * lc + MAX_CHUNK * 132 + MAX_CHUNK * 72
                + 3 * MAX_CHUNK + MAX_HD)


def _check(q, k, v, i_gate, f_gate, c0, out, n0, n_out, chunk):
    refuse_grad(NAME, q, k, v, i_gate, f_gate, c0, out, n0, n_out)
    states = tuple(t for t in (c0, out, n0, n_out) if t is not None)
    ts = (q, k, v, i_gate, f_gate) + states
    if not all(t.is_cuda for t in ts):
        raise ValueError("mlstm_scan kernel needs CUDA tensors; got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError("all inputs must be on one device")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype
                                    for t in (k, v, i_gate, f_gate)):
        raise ValueError(f"dtypes of q, k, v, i, f must match and be fp32 or "
                         f"bf16: {[t.dtype for t in ts[:5]]}")
    if any(t.dtype != torch.float32 for t in states):
        raise ValueError("c0, out, n0 and n_out must be fp32")
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
    if n0 is None and n_out is not None:
        raise ValueError("n_out needs n0")
    if any(t is not None and t.shape != (B, H, hd) for t in (n0, n_out)):
        raise ValueError(f"n0 and n_out must be {(B, H, hd)}")
    if S < 1 or hd % 16 or not 16 <= hd <= MAX_HD:
        raise ValueError(f"need S >= 1 and head_dim a multiple of 16 in "
                         f"[16, {MAX_HD}]: S {S}, head_dim {hd}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside [1, {MAX_CHUNK}]")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("last dim of q, k, v must be contiguous (stride 1)")
    if not all(t.is_contiguous() for t in states):
        raise ValueError("c0, out, n0 and n_out must be contiguous")
    # Rows of q, k, v and of the states are read as 16-byte vectors.
    if any(t.data_ptr() % 16 for t in (q, k, v) + states) or any(
            st * t.element_size() % 16 for t in (q, k, v)
            for st in t.stride()[:3]):
        raise ValueError("q, k, v (pointers and batch/seq/head strides) and "
                         "the states must be 16-byte aligned")


def mlstm_scan(q, k, v, i_gate, f_gate, c0, *, chunk=DEFAULT_CHUNK,
               out=None, n0=None, n_out=None):
    """q,k,v: (B,S,H,hd)  i,f: (B,S,H) in (0,1)  c0: (B,H,hd,hd) fp32.

    Returns (y (B,S,H,hd) in q's dtype, c_last (B,H,hd,hd) fp32), as the
    TPU kernel does; with ``n0`` (B,H,hd) fp32 also n_last, the normalizer
    after the sequence.  q, k, v and the gates may have any strides with a
    unit last dim.  ``out`` (fp32, contiguous) receives c_last and may be
    ``c0`` itself, as ``n_out`` may be ``n0``: the decode step then updates
    the cache in place.
    """
    global launches
    chunk = min(int(chunk), q.shape[1])
    _check(q, k, v, i_gate, f_gate, c0, out, n0, n_out, chunk)
    B, S, H, hd = q.shape
    y = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if out is None:
        out = torch.empty_like(c0)
    if n0 is not None and n_out is None:
        n_out = torch.empty_like(n0)
    scores = None
    if chunk > 1:   # each chunk's causal score tile, fp32, rows padded to 8
        scores = torch.empty(
            (B * H, -(-S // chunk), chunk, -(-chunk // 8) * 8),
            dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *i_gate.stride(), *f_gate.stride(), *y.stride()[:3])

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), i_gate.data_ptr(), f_gate.data_ptr(),
            c0.data_ptr(), y.data_ptr(), out.data_ptr(), ptr(n0),
            ptr(n_out), ptr(scores), B, S, H, hd, chunk, strides, stream)
    if err != 0:
        raise RuntimeError(f"mlstm_scan launch failed: CUDA error {err}")
    launches += 1
    if n0 is None:
        return y, out
    return y, out, n_out
