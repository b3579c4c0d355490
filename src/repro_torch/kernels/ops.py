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
(``layers.attention_on_shards``).  The scans' DTensor entries are
``selective_scan_on_shards`` and ``mlstm_on_shards``: a scan (the kernel
wrapper, or the model's plain version) on each rank's local shards, cut
where the recurrence allows it.  The four kernel wrappers take local
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
            f"rank's shards (ops.attention, selective_scan_on_shards and "
            f"mlstm_on_shards do)")


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


def _shards(ts, plan, grads):
    """The local tensors of the DTensors ``ts``, each first redistributed
    to its row of ``plan`` (placements per mesh dim; a mesh dim of one
    rank moves nothing), its gradient declared placed as its row of
    ``grads``."""
    return [t.redistribute(t.device_mesh, want).to_local(grad_placements=g)
            for t, want, g in zip(ts, plan, grads)]


def selective_scan_on_shards(scan, u, dt, a, b, c, h0, *, out=None):
    """``scan`` (``selective_scan``'s contract: the kernel wrapper, or the
    model's plain chunked scan) on each rank's local shards of the
    DTensors u, dt (B,S,di), a (di,N), b, c (B,S,N) and h0 (B,di,N).
    Returns (y placed as u's shards, h_last placed as h0's); h_last is
    ``out`` (a DTensor cache placed as h0's shards) when given, written in
    place.

    The channels are independent: per mesh dim, a block of the batch (u
    ``Shard(0)``: b, c and h0 cut alike, a whole) or of ``di`` (u
    ``Shard(2)``: a cut on di as u is, h0 on its dim 1, b and c whole).
    Any other placement of u (a cut sequence, a pending sum) is made whole
    first.  A rank that uses a whole a (or b, c) with its block declares
    that gradient a pending sum over the mesh dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..launch.sharding import from_local
    mesh = u.device_mesh
    rows = []          # per mesh dim: (u and dt, a, b and c, h0), a's
    for p in u.placements:           # and b's and c's gradients
        if p == Shard(0):
            rows.append((p, Replicate(), p, p, Partial(), p))
        elif p == Shard(2):
            rows.append((p, Shard(0), Replicate(), Shard(1), Shard(0),
                         Partial()))
        else:
            rows.append((Replicate(),) * 6)
    up, ap, bp, hp, ag, bg = (list(r) for r in zip(*rows))
    ul, dtl, al, bl, cl, hl = _shards((u, dt, a, b, c, h0),
                                      (up, up, ap, bp, bp, hp),
                                      (up, up, ag, bg, bg, hp))
    kw = {} if out is None else {"out": _target(out, hp)}
    y, h_last = scan(ul, dtl, al, bl, cl, hl, **kw)
    return (from_local(y, mesh, up, u.shape),
            out if out is not None else from_local(h_last, mesh, hp,
                                                   h0.shape))


def mlstm_on_shards(cell, q, k, v, i_gate, f_gate, c0, n0, *, out=None,
                    n_out=None):
    """``cell`` (``mlstm``'s contract with ``n0``: the kernel wrapper, or
    the model's plain chunkwise cell) on each rank's local shards of the
    DTensors q, k, v (B,S,H,hd), i, f (B,S,H), c0 (B,H,hd,hd) and n0
    (B,H,hd).  Returns (y, c_last, n_last), placed as the shards the cell
    ran on; c_last and n_last are ``out`` and ``n_out`` (DTensor caches
    placed so) when given, written in place.

    Only the batch is cut (the JAX package's cache ``C`` is ("batch",
    None, None, None)): per mesh dim every tensor holds the same block of
    the batch where q does, else all are whole (a cut head dim, a pending
    sum, a cut sequence are gathered first)."""
    from torch.distributed.tensor import Replicate, Shard

    from ..launch.sharding import from_local
    mesh = q.device_mesh
    plan = [p if p == Shard(0) else Replicate() for p in q.placements]
    ts = (q, k, v, i_gate, f_gate, c0, n0)
    ql, kl, vl, il, fl, cl, nl = _shards(ts, (plan,) * 7, (plan,) * 7)
    kw = {} if out is None else {"out": _target(out, plan),
                                 "n_out": _target(n_out, plan)}
    y, c_last, n_last = cell(ql, kl, vl, il, fl, cl, n0=nl, **kw)
    if out is None:
        return (from_local(y, mesh, plan, q.shape),
                from_local(c_last, mesh, plan, c0.shape),
                from_local(n_last, mesh, plan, n0.shape))
    return from_local(y, mesh, plan, q.shape), out, n_out


def _target(out, placements):
    """The local tensor of the DTensor ``out``, which a scan on shards
    placed as ``placements`` writes in place: its shard must be theirs on
    every mesh dim of more than one rank (a cache placed by its spec is)."""
    mesh = out.device_mesh
    if any(mesh.size(d) > 1 and p != q
           for d, (p, q) in enumerate(zip(out.placements, placements))):
        raise ValueError(f"out is placed {tuple(out.placements)}, the scan's "
                         f"state {tuple(placements)}")
    return out.to_local()


_KERNELS = (_fa, decode_attention, mlstm_scan, mamba_scan)


def launch_counts() -> Dict[str, int]:
    return {m.NAME: m.launches for m in _KERNELS}


def reset_launch_counts() -> None:
    for m in _KERNELS:
        m.launches = 0
