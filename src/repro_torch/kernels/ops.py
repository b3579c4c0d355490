"""Dispatch between the CUDA kernels and their plain PyTorch versions.

A CPU tensor goes to the plain version (``ref.attention_ref``,
``ref.mamba_scan_ref``, ``ref.mlstm_ref``); a CUDA tensor goes to the
kernel, which launches or raises.  Nothing here catches a kernel's failure
and falls back.

``attention`` is the model-facing entry with the signature and
``(B,S,N,hd)`` layout of ``layers.attention``: a causal call (prefill,
train) runs ``flash_attention``; a one-token decode call against the cache
runs ``flash_decode``.  The head-major views it passes are transposes, not
copies.  On DTensors it runs them on each rank's local shards
(``layers.attention_on_shards``).  The four kernel wrappers take local
tensors only and raise ``TypeError`` on a DTensor, whose storage is not
the tensor it stands for.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..launch.sharding import is_dtensor
from . import decode_attention, flash_attention as _fa, mamba_scan, \
    mlstm_scan, ref


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def _local_only(name: str, *tensors) -> None:
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(
            f"{name} takes local tensors, not a DTensor: run it on each "
            f"rank's shards (ops.attention does, through "
            f"layers.attention_on_shards)")


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0, kv_len=None):
    """q: (B,Hq,Sq,hd)  k,v: (B,Hkv,Skv,hd) -> (B,Hq,Sq,hd)."""
    _local_only("flash_attention", q, k, v)
    if _on_cpu(q):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_offset=q_offset,
                                 kv_len=kv_len)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset,
                               kv_len=kv_len)


def flash_decode(q, k, v, kv_len: int, *, softcap=0.0):
    """q: (B,Hq,1,hd)  k,v: (B,Hkv,T,hd) -> (B,Hq,1,hd)."""
    _local_only("flash_decode", q, k, v)
    if _on_cpu(q):
        return ref.attention_ref(q, k, v, causal=False, softcap=softcap,
                                 kv_len=kv_len)
    return decode_attention.flash_decode(q, k, v, kv_len, softcap=softcap)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              cap: float = 0.0, q_offset: int = 0,
              kv_len: Optional[int] = None):
    """``layers.attention``'s contract, q:(B,S,Nq,hd) k,v:(B,T,Nkv,hd),
    computed by the kernels.  As in the JAX package, ``window`` applies only
    with ``causal``.  On DTensors, the kernels run on the local shards; a
    decode cache cut on its sequence over several ranks is merged from
    ``layers.attention_lse`` on the CPU and refused on the card, whose
    kernels return no log-sum-exp."""
    if is_dtensor(q):
        from ..models.layers import attention_lse, attention_on_shards
        return attention_on_shards(
            attention, q, k, v, causal=causal, window=window, cap=cap,
            q_offset=q_offset, kv_len=kv_len,
            partial=attention_lse if _on_cpu(q) else None)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if not causal and q.shape[1] == 1 and kv_len is not None:
        o = flash_decode(qh, kh, vh, kv_len, softcap=cap)
    else:
        o = flash_attention(qh, kh, vh, causal=causal, window=window,
                            softcap=cap, q_offset=q_offset, kv_len=kv_len)
    return o.transpose(1, 2)


def selective_scan(u, dt, a, b, c, h0, *, out=None):
    """The TPU kernel ``mamba_scan``'s contract: u,dt (B,S,di), a (di,N)
    fp32, b,c (B,S,N), h0 (B,di,N) fp32 -> (y (B,S,di) in u's dtype,
    h_last fp32).  ``out``, when given, receives h_last (it may be h0
    itself) and is returned."""
    _local_only("selective_scan", u, dt, a, b, c, h0, out)
    if _on_cpu(u):
        y, h_last = ref.mamba_scan_ref(u, dt, a, b, c, h0)
        if out is not None:
            h_last = out.copy_(h_last)
        return y.to(u.dtype), h_last
    return mamba_scan.mamba_scan(u, dt, a, b, c, h0, out=out)


def mlstm(q, k, v, i_gate, f_gate, c0, *, n0=None,
          chunk=mlstm_scan.DEFAULT_CHUNK, out=None, n_out=None):
    """The TPU kernel ``mlstm_scan``'s contract: q,k,v (B,S,H,hd), i,f
    (B,S,H) in (0,1), c0 (B,H,hd,hd) fp32 -> (y (B,S,H,hd) in q's dtype,
    c_last fp32).  With ``n0`` (B,H,hd) fp32 it also returns n_last, the
    normalizer: C's update with v = 1.  ``out`` and ``n_out``, when given,
    receive c_last and n_last (they may be c0 and n0 themselves) and are
    returned."""
    _local_only("mlstm", q, k, v, i_gate, f_gate, c0, n0, out, n_out)
    if _on_cpu(q):
        if n0 is None and n_out is not None:
            raise ValueError("n_out needs n0")
        B, _, H, hd = q.shape
        n_in = n0 if n0 is not None else torch.zeros(
            (B, H, hd), dtype=torch.float32, device=q.device)
        y, c_last, n_last = ref.mlstm_ref(q, k, v, i_gate, f_gate, c0, n_in)
        if out is not None:
            c_last = out.copy_(c_last)
        if n0 is None:
            return y.to(q.dtype), c_last
        if n_out is not None:
            n_last = n_out.copy_(n_last)
        return y.to(q.dtype), c_last, n_last
    return mlstm_scan.mlstm_scan(q, k, v, i_gate, f_gate, c0, chunk=chunk,
                                 out=out, n0=n0, n_out=n_out)


_KERNELS = (_fa, decode_attention, mlstm_scan, mamba_scan)


def launch_counts() -> Dict[str, int]:
    return {m.NAME: m.launches for m in _KERNELS}


def reset_launch_counts() -> None:
    for m in _KERNELS:
        m.launches = 0
