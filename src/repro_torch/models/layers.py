"""Shared layers: the port of ``repro.models.layers`` for the dense decoder.

Conventions:
  * Parameters are declared once as ``PSpec`` trees (shape + logical
    sharding axes + init), from which ``init_tensor`` draws real tensors
    with an explicit ``torch.Generator`` (the same per-leaf distributions
    as the JAX package; the numbers differ, so tests carry the JAX weights
    over instead), and ``param_structs`` builds tensors on the ``meta``
    device, DTensors placed by ``launch.sharding`` rules, which allocate
    nothing.  A spec tree is a dict (or list) of ``PSpec`` and subtrees.
  * The model code annotates its activations with ``launch.sharding.
    constrain`` where the JAX package's does: the identity on plain
    tensors, a redistribution of DTensors under active rules.  On a model
    of DTensor parameters (``LM(..., rules=)``), ``dense`` gathers a
    weight to its use-time placement (``UP_W`` / ``DOWN_W``), the rope
    tables join the mesh replicated, and the attention runs on each rank's
    local shards (``attention_on_shards``), where its masks are built.
  * ``attention`` is the plain, exact attention in the model's
    ``(B, S, N, hd)`` layout.  Above ``CHUNK_THRESHOLD`` query tokens it
    takes ``_chunked_attention``, the JAX package's online-softmax form
    over query and key chunks, so a 32k-token prefill never builds the
    O(S²) fp32 score tensor.  The kernels in ``repro_torch.kernels``
    compute the same function on the card.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..launch.sharding import (constrain, from_local, is_dtensor, place,
                               shard_bounds, shard_offsets)

CHUNK_THRESHOLD = 8_192   # switch to chunked attention above this seq len
Q_CHUNK = 2_048
KV_CHUNK = 2_048


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # a logical axis name (or None) a dim
    init: str = "normal"            # normal | zeros | ones
    scale: Optional[float] = None   # stddev; None => 1/sqrt(fan_in = shape[-2])
    # None => the caller's dtype; recurrent states pin fp32 whatever it is
    dtype: Optional[torch.dtype] = None

    def stddev(self) -> float:
        if self.scale is not None:
            return self.scale
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return 1.0 / math.sqrt(max(1, fan_in))


def map_specs(fn: Callable[[PSpec], Any], tree):
    """``fn`` of every ``PSpec`` of a spec tree, in the tree's shape."""
    if isinstance(tree, PSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return [map_specs(fn, v) for v in tree]


def struct(shape, dtype, rules, axes, device="meta"):
    """A zeroed tensor of ``shape`` on ``device`` (on ``meta``, nothing
    allocated): with ``rules``, a DTensor with that global shape, placed
    over ``rules.mesh`` as ``rules.sharding(axes, shape)`` says, whose
    local tensor is this rank's shard (a ragged last shard where the axes
    do not divide the dim, as ``Shard`` cuts it).  The port's counterpart
    of a ``jax.ShapeDtypeStruct`` with a ``NamedSharding``."""
    shape = tuple(shape)
    if rules is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    mesh, placements = rules.sharding(axes, shape)
    local = torch.zeros(shard_bounds(shape, mesh, placements)[1],
                        dtype=dtype, device=device)
    return from_local(local, mesh, placements, shape)


def param_structs(spec_tree, rules, dtype=torch.bfloat16):
    """Each leaf as a ``struct``: a pinned ``PSpec.dtype`` (the recurrent
    states' fp32) wins over ``dtype``."""
    return map_specs(lambda s: struct(s.shape, s.dtype or dtype, rules,
                                      s.axes), spec_tree)


def param_shardings(spec_tree, rules):
    """Each leaf's DTensor placements under ``rules``, one per mesh dim."""
    return map_specs(lambda s: rules.placements(s.axes, s.shape), spec_tree)


def stack_specs(spec_tree, n: int):
    """Add a leading layer-stack dim (the JAX package's scan-over-layers
    layout)."""
    return map_specs(
        lambda s: PSpec((n,) + s.shape, (None,) + s.axes, s.init, s.scale,
                        s.dtype), spec_tree)


# A normal leaf of more elements than this is drawn slice by slice along its
# leading axis.  Only kimi-k2's expert leaves (384 x 7,168 x 2,048 = 5.64 G
# elements each) are above it; the largest other leaf is qwen2-vl's
# 1.25 G-element embedding.
SLICED_DRAW_ELEMENTS = 2 ** 31


def init_tensor(spec: PSpec, generator: torch.Generator, *, dtype,
                device, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One leaf: zeros, ones, or normal·stddev drawn from ``generator``
    (which must live on ``device``), written into ``out`` when it is given.

    A normal leaf is drawn in fp32 and then cast, in place: the largest
    leaves are drawn next to a model that already fills most of the card.
    An fp32 leaf is drawn where it lies (``normal_`` gives ``randn``'s
    numbers), any other through an fp32 copy.  A leaf of more than
    ``SLICED_DRAW_ELEMENTS`` elements is drawn slice by slice along its
    leading axis (the same distribution, from the same generator), so that
    no fp32 copy of the whole leaf is held: kimi-k2's expert leaf would be
    22.5 GB of fp32.  A smaller leaf is drawn whole."""
    if out is None:
        out = torch.empty(spec.shape, dtype=dtype, device=device)
    if spec.init in ("zeros", "ones"):
        return out.fill_(float(spec.init == "ones"))
    parts = out.unbind(0) if out.numel() > SLICED_DRAW_ELEMENTS else (out,)
    for part in parts:
        if part.dtype == torch.float32:
            part.normal_(generator=generator).mul_(spec.stddev())
        else:
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32,
                                   device=device).mul_(spec.stddev()))
    return out


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    # Variance in fp32; the x path stays in its own dtype (as in JAX).
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + weight.to(x.dtype))


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return (cap * torch.tanh(x / cap)) if cap > 0 else x


# ---------------------------------------------------------------------------
# RoPE (standard, per-kind theta, M-RoPE)
# ---------------------------------------------------------------------------
def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))


@functools.lru_cache(maxsize=32)
def _rope_freqs_on(hd: int, theta: float, device: torch.device):
    # Built once per (hd, theta, device): a host-to-device copy on every
    # call would synchronize the stream twice per layer per decode step.
    return torch.tensor(rope_freqs(hd, theta), dtype=torch.float32,
                        device=device)


def rope_cos_sin(positions: torch.Tensor, hd: int, theta: float):
    """(cos, sin) of the rotary angles, each (..., S, 1, hd/2) fp32; placed
    as ``positions`` when they are a DTensor (the frequencies replicated
    on its mesh)."""
    freqs = place(_rope_freqs_on(hd, float(theta), positions.device),
                  (None,), positions)
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE of x: (..., S, N, hd) by ``rope_cos_sin`` tables."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, N, hd); positions: broadcastable to (..., S)."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def mrope_cos_sin(positions: torch.Tensor, hd: int, theta: float,
                  sections: Tuple[int, int, int]):
    """Qwen2-VL multimodal RoPE tables for ``rotate``.  ``positions`` is
    (3, ..., S): the temporal, height and width streams.  ``sections``
    splits the hd/2 frequency dims; dim j takes its angle from the stream
    of the section it falls in.  Returns (cos, sin), each (..., S, 1, hd/2)
    fp32, as ``rope_cos_sin``."""
    assert sum(sections) == hd // 2, (sections, hd)
    freqs = place(_rope_freqs_on(hd, float(theta), positions.device),
                  (None,), positions)
    # The stream each frequency dim reads, laid out along the last axis.
    sel = torch.cat([positions[i][..., None].expand(*positions.shape[1:], n)
                     for i, n in enumerate(sections)], dim=-1)
    ang = sel.float() * freqs                               # (..., S, hd/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """x: (B, S, N, hd); positions: (3, B, S)."""
    return rotate(x, *mrope_cos_sin(positions, x.shape[-1], theta, sections))


def text_positions(batch: int, seq: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.int32, device=device) + offset
    return pos[None, :].expand(batch, seq)


def mrope_positions(batch: int, n_patches: int, n_text: int,
                    device=None) -> torch.Tensor:
    """The stub VLM layout, (3, B, S) int32: image patches on a ceil(sqrt n)
    grid (t = 0, h = row, w = column), then text at ``n_patches + i`` on all
    three streams.  As in the JAX package, text starts at ``n_patches``,
    not past the grid's largest index as in the published Qwen2-VL."""
    grid = max(1, math.ceil(math.sqrt(max(1, n_patches))))
    idx = np.arange(n_patches)
    t_text = n_patches + np.arange(n_text)
    pos = np.stack([np.concatenate([np.zeros(n_patches, np.int64), t_text]),
                    np.concatenate([idx // grid, t_text]),
                    np.concatenate([idx % grid, t_text])])     # (3, S)
    pos = torch.tensor(pos, dtype=torch.int32, device=device)
    return pos[:, None, :].expand(3, batch, n_patches + n_text)


# ---------------------------------------------------------------------------
# Attention (plain, exact)
# ---------------------------------------------------------------------------
def _mask_bias(q_pos, k_pos, window: int) -> torch.Tensor:
    """Additive causal (+ optional sliding-window) bias, fp32."""
    keep = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        keep &= (q_pos[:, None] - k_pos[None, :]) < window
    zero = torch.zeros((), dtype=torch.float32, device=keep.device)
    return torch.where(keep, zero, torch.full_like(zero, -1e30))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, cap: float = 0.0,
              q_offset: int = 0, kv_len: Optional[int] = None,
              ) -> torch.Tensor:
    """Exact attention. q:(B,S,Nq,hd) k,v:(B,T,Nkv,hd) -> (B,S,Nq,hd).

    GQA by head grouping; ``window`` applies with ``causal`` only (as in the
    JAX package); ``q_offset`` is the absolute position of q[0]; ``kv_len``
    masks keys at or past it (decode against a preallocated cache).  Above
    ``CHUNK_THRESHOLD`` query tokens it takes ``_chunked_attention``;
    decode (one query token) never does.
    """
    if is_dtensor(q):
        return attention_on_shards(
            attention, q, k, v, causal=causal, window=window, cap=cap,
            q_offset=q_offset, kv_len=kv_len, partial=attention_lse)
    B, S, Nq, hd = q.shape
    T, Nkv = k.shape[1], k.shape[2]
    G = Nq // Nkv
    qg = (q * (1.0 / math.sqrt(hd))).reshape(B, S, Nkv, G, hd)
    if S > CHUNK_THRESHOLD:
        return _chunked_attention(qg, k, v, causal=causal, window=window,
                                  cap=cap, q_offset=q_offset, kv_len=kv_len
                                  ).reshape(B, S, Nq, hd)
    s = torch.einsum("bsngh,btnh->bngst", qg.float(), k.float())
    s = softcap(s, cap)
    q_pos = torch.arange(S, device=q.device) + q_offset
    k_pos = torch.arange(T, device=q.device)
    if causal:
        s = s + _mask_bias(q_pos, k_pos, window)
    if kv_len is not None:
        s = s.masked_fill(~(k_pos < kv_len), -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngst,btnh->bsngh", p.to(v.dtype), v)
    return o.reshape(B, S, Nq, hd)


def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  cap: float = 0.0, kv_len: Optional[int] = None):
    """Non-causal attention (decode against a cache) and the log-sum-exp
    of each query's scores: (o (B,S,Nq,hd), lse (B,S,Nq) fp32).  Keys at or
    past ``kv_len`` (which may be 0 or less) are masked; with no key at
    all, lse is -inf and o is zero."""
    B, S, Nq, hd = q.shape
    T, Nkv = k.shape[1], k.shape[2]
    G = Nq // Nkv
    qg = (q * (1.0 / math.sqrt(hd))).reshape(B, S, Nkv, G, hd)
    s = softcap(torch.einsum("bsngh,btnh->bngst", qg.float(), k.float()),
                cap)
    if kv_len is not None:
        s = s.masked_fill(~(torch.arange(T, device=q.device) < kv_len),
                          -1e30)
    lse = torch.logsumexp(s, dim=-1)                      # (B,Nkv,G,S)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bngst,btnh->bsngh", p.to(v.dtype), v)
    return o.reshape(B, S, Nq, hd), lse.permute(0, 3, 1, 2).reshape(B, S, Nq)


def attention_on_shards(attend, q, k, v, *, causal: bool, window: int,
                        cap: float, q_offset: int, kv_len: Optional[int],
                        partial=None):
    """``attend`` (``layers.attention``'s contract) on each rank's local
    shards of the DTensors q (B,S,Nq,hd) and k, v (B,T,Nkv,hd); returns o,
    a DTensor placed as q.

    Each mesh dim cuts the batch of all three alike; or q's heads, k and v
    whole on it, where a rank attends its block of q heads with the KV
    heads of their GQA groups (``_kv_for_heads``); or, with q whole on it,
    the keys' sequence (a decode cache): each rank attends its own keys
    with ``partial`` (``attention_lse``'s contract) and the partial
    outputs are merged by their log-sum-exp, an all-reduce of the maxima
    and one of the weighted sums, so the cache is never gathered.  Other
    placements are redistributed to one of these first.  The masks are
    built on the local shards, at their global positions."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    B, S, Nq, hd = q.shape
    # Per mesh dim: (q's placement, k's and v's, their gradients').
    plan = []
    for d in range(mesh.ndim):
        a, b = q.placements[d], k.placements[d]
        if mesh.size(d) == 1:       # every tensor whole on it
            plan.append((a, b, b))
        elif a == Shard(0):
            plan.append((a, a, a))
        elif a == Shard(2):
            # Each rank uses its own KV heads: their gradients add up.
            plan.append((a, Replicate(), Partial()))
        elif b == Shard(1) and v.placements[d] == b:
            plan.append((Replicate(), b, b))
        else:
            plan.append((Replicate(),) * 3)
    qp, kp, kgrad = (list(t) for t in zip(*plan))
    seq = [d for d, (a, b, _) in enumerate(plan)
           if mesh.size(d) > 1 and b == Shard(1)]
    if seq and (causal or partial is None):
        raise NotImplementedError(
            "keys cut on their sequence dim are attended only by a decode "
            "call (causal=False) with a partial attention to merge; the "
            "kernels return no log-sum-exp")
    q, k, v = (q.redistribute(mesh, qp), k.redistribute(mesh, kp),
               v.redistribute(mesh, kp))
    h0, t0 = shard_offsets(q)[2], shard_offsets(k)[1]
    ql = q.to_local(grad_placements=qp)
    kl, vl = (t.to_local(grad_placements=kgrad) for t in (k, v))
    n = ql.shape[2]
    if n == 0:      # a ragged head shard left this rank none
        return from_local(ql + 0.0 * (kl.sum() + vl.sum()), mesh, qp,
                          q.shape)
    if n < Nq:
        kl, vl = _kv_for_heads(kl, vl, h0, n, Nq // k.shape[2])
    if not seq:
        o = attend(ql, kl, vl, causal=causal, window=window, cap=cap,
                   q_offset=q_offset, kv_len=kv_len)
        return from_local(o, mesh, qp, q.shape)
    o, lse = partial(ql, kl, vl, cap=cap,
                     kv_len=None if kv_len is None else kv_len - t0)

    def merged(t, op, shape):
        pl = [Partial(op) if d in seq else qp[d] for d in range(mesh.ndim)]
        out = [Replicate() if d in seq else qp[d] for d in range(mesh.ndim)]
        return from_local(t, mesh, pl, shape).redistribute(
            mesh, out).to_local()

    w = torch.exp(lse - merged(lse, "max", (B, S, Nq)))
    num = merged(torch.cat([o.float() * w[..., None], w[..., None]], -1),
                 "sum", (B, S, Nq, hd + 1))
    return from_local((num[..., :hd] / num[..., hd:]).to(o.dtype), mesh, qp,
                      q.shape)


def _kv_for_heads(k, v, h0: int, n: int, group: int):
    """The KV heads (dim 2) that q heads h0 .. h0+n-1 attend, laid out so
    that a call on these n q heads, which maps q head i to KV head
    i // (n / n_kv), picks each head's own: the contiguous block of KV
    heads when that mapping holds, else one KV head per q head."""
    want = [(h0 + i) // group for i in range(n)]
    lo, m = want[0], want[-1] - want[0] + 1
    if n % m == 0 and all(w - lo == i // (n // m)
                          for i, w in enumerate(want)):
        return k[:, :, lo:lo + m], v[:, :, lo:lo + m]
    idx = torch.tensor(want, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _chunked_attention(qg, k, v, *, causal, window, cap, q_offset, kv_len):
    """Exact attention over query chunks x key chunks with an fp32 running
    (max, sum, acc): the JAX package's ``_chunked_attention``, its two
    ``lax.scan``s as Python loops, the same arithmetic in the same order.
    qg: (B, S, Nkv, G, hd), already scaled; k, v: (B, T, Nkv, hd).  Never
    holds more than one (qc x kc) block of scores.  The chunk sizes are
    read from the module at call time."""
    B, S, Nkv, G, hd = qg.shape
    T = k.shape[1]
    qc, kc = min(Q_CHUNK, S), min(KV_CHUNK, T)
    n_q, n_k = -(-S // qc), -(-T // kc)
    qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, n_q * qc - S))
    kp = F.pad(k, (0, 0, 0, 0, 0, n_k * kc - T))
    vp = F.pad(v, (0, 0, 0, 0, 0, n_k * kc - T))
    valid_t = T if kv_len is None else kv_len
    dev = qg.device
    outs = []
    for qi in range(n_q):
        qblk = qg[:, qi * qc:(qi + 1) * qc].float()
        q_pos = qi * qc + torch.arange(qc, device=dev) + q_offset
        m = torch.full((B, Nkv, G, qc), -math.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Nkv, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Nkv, G, qc, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(n_k):
            kblk = kp[:, ki * kc:(ki + 1) * kc]
            vblk = vp[:, ki * kc:(ki + 1) * kc]
            k_pos = ki * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bsngh,btnh->bngst", qblk, kblk.float())
            s = softcap(s, cap)
            keep = k_pos[None, :] < valid_t
            if causal:
                keep = keep & (k_pos[None, :] <= q_pos[:, None])
                if window > 0:
                    keep = keep & ((q_pos[:, None] - k_pos[None, :]) < window)
            else:
                keep = keep.expand(qc, kc)
            s = s.masked_fill(~keep, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bngst,btnh->bngsh", p.to(vblk.dtype), vblk)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B,qc,Nkv,G,hd)
    return torch.cat(outs, dim=1)[:, :S].to(v.dtype)


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------
def dense(x: torch.Tensor, w: torch.Tensor,
          use_axes: Optional[Tuple] = None) -> torch.Tensor:
    """x: (..., d_in) @ w: (d_in, d_out).

    ``use_axes`` is the weight's placement at use time (the JAX
    package's): a ZeRO-3 weight stored with its contraction dim cut over
    "data" is gathered to it, so the activations keep their batch
    sharding instead of being replicated and partial-summed over d."""
    if use_axes is not None:
        w = constrain(w, use_axes)
    return rows_product(torch.matmul, x, w)


def rows_product(product, x, w):
    """``product(x, w)`` of x (..., d), which flattens x's leading dims
    into rows.  Torch 2.11's DTensor refuses that flattening where a dim
    after the first is cut (the sequence, under the "sp" profile), so a
    DTensor x is made whole there first (the all-gather that sequence
    parallelism puts before a projection), and the product's gradient on
    the way back is redistributed to the product's own placements by a
    redistribution that moves nothing forward."""
    if not is_dtensor(x):
        return product(x, w)
    from torch.distributed.tensor import Replicate
    cut = [p.is_shard() and 0 < p.dim < x.ndim - 1 for p in x.placements]
    if any(cut):
        x = x.redistribute(x.device_mesh, [
            Replicate() if c else p for c, p in zip(cut, x.placements)])
    out = product(x, w)
    return out.redistribute(out.device_mesh, out.placements)


UP_W = (None, "model")     # use-time spec for (d_model, wide) weights
DOWN_W = ("model", None)   # use-time spec for (wide, d_model) weights


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(dense(x, w_gate, UP_W)) * dense(x, w_up, UP_W)
    h = constrain(h, ("batch", None, "model"))
    return dense(h, w_down, DOWN_W)
