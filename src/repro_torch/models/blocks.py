"""Decoder blocks: the port of ``repro.models.blocks`` for the attention
kinds ``attn`` and ``attn_local`` (the same block; the LM gives a local
layer its window and rope theta), the ``mamba`` kind, the xLSTM kinds
``mlstm`` and ``slstm``, and the FFN, dense or MoE.

Every kind implements
  specs(cfg)                    -> {name: PSpec} for one layer
  apply(cfg, params, x, ctx)    -> (x_out, cache)
with ``ctx`` carrying the mode ("train" | "prefill" | "decode"), the rope
tables, the window and the layer's cache.

The JAX package updates its caches functionally and returns new ones.  The
port writes into preallocated caches in place: the prefill writes the
prompt's K/V at ``[:, :S]`` of a zeroed ``(B, T, Nkv, hd)`` cache (the JAX
package pads to ``max_len``), a decode step writes at ``[:, pos:pos+S]``;
the recurrent kinds ``copy_`` their new state into the cache tensors (or
have the kernel write it there).
The LM hands each layer views of the stacked cache, so returning a fresh
tensor instead would leave the cache as it was.  A DTensor cache, cut on
its sequence dim, is written on each rank's own shard (``write_rows``).

Every kind runs on DTensor parameters as the JAX package's blocks do
under its rules.  The attention block and the dense FFN constrain their
activations where the JAX package's do (q, k, v, the attention output,
the FFN's hidden activation, the layer's output); the MoE FFN takes
DTensor activations too (``moe.moe_apply``: the expert-parallel branch
under "default" and "sp", the single shard under "fsdp").  The recurrent
kinds project in and out on DTensors, with the weights at their use-time
placements (``UP_W`` / ``DOWN_W``), and run their recurrence on each
rank's local shards: the mamba scan on a block of the channels or of the
batch (``ops.selective_scan_on_shards``, after mamba's ``xs`` is
constrained to ("batch", None, "model") as in the JAX package), the mLSTM
cell on a block of the batch (``ops.mlstm_on_shards``), the sLSTM time
loop on a block of the batch with its gate inputs whole
(``_slstm_on_shards``).  A sequence cut by "sp" is gathered before each
of them.  Their zero states are placed as their cache specs
(``_zeros``), and their caches are written on each rank's own shard
(``_store``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import obs
from ..kernels import ops
from ..launch.sharding import (constrain, current_rules, from_local, frozen,
                               is_dtensor, shard_offsets)
from .config import ModelConfig
from .layers import (DOWN_W, UP_W, PSpec, attention, dense, rms_norm,
                     rotate, struct, swiglu)
from .moe import moe_apply, moe_specs

SSM_CHUNK = 64      # mamba: tokens per associative-scan chunk (plain scan)
MLSTM_CHUNK = 256   # mLSTM: chunkwise-parallel block size of the plain cell

ATTN_KINDS = ("attn", "attn_local")
FFN_KINDS = ATTN_KINDS + ("mamba",)     # the kinds that carry an FFN

@dataclass
class Ctx:
    mode: str                       # train | prefill | decode
    # (cos, sin) of the positions at the layer's rope theta
    # (layers.rope_cos_sin, or mrope_cos_sin under M-RoPE), None when the
    # model has no attention.  The JAX
    # Ctx carries positions and theta and every layer recomputes the
    # angles; here the LM computes one table per theta once per pass
    # (``LM.rope``), which saves launches and gives the same numbers.
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    window: int = 0                 # 0 = global attention
    cache: Any = None               # the layer's cache dict (views, in place)
    pos_offset: int = 0             # absolute position of x[0]
    max_len: int = 0                # cache capacity
    plain: bool = False             # plain PyTorch instead of the kernels


# Q and the attention output: heads on the TP axis.  K and V stay
# replicated on it (G x smaller than Q under GQA), as in the JAX package,
# whose partitioner rematerialized them when they were sharded on another
# dim than Q.
HEAD_AXES = ("batch", None, "model", None)
KV_REPLICATED = ("batch", None, None, None)


# ===========================================================================
# Attention
# ===========================================================================
def attn_specs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    s = {
        "ln": PSpec((d,), (None,), init="zeros"),
        "wq": PSpec((d, nq * hd), ("fsdp", "model")),
        "wk": PSpec((d, nkv * hd), ("fsdp", "model")),
        "wv": PSpec((d, nkv * hd), ("fsdp", "model")),
        "wo": PSpec((nq * hd, d), ("model", "fsdp")),
    }
    if cfg.qk_norm:
        s["q_norm"] = PSpec((hd,), (None,), init="zeros")
        s["k_norm"] = PSpec((hd,), (None,), init="zeros")
    if cfg.post_norm:
        s["post_ln"] = PSpec((d,), (None,), init="zeros")
    return s


def attn_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    # Sequence-sharded KV cache (flash-decode): batch holds "data", so the
    # cache seq dim takes "model"; at batch=1 it takes both axes.
    kv_axes = ("batch", "cache_seq_full" if batch == 1 else "cache_seq",
               None, None)
    return {"k": PSpec(shape, kv_axes, init="zeros"),
            "v": PSpec(shape, kv_axes, init="zeros")}


def attn_apply(cfg: ModelConfig, p: Mapping[str, torch.Tensor], x, ctx: Ctx):
    B, S, _ = x.shape
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = _even_heads(dense(h, p["wq"], UP_W), nq).reshape(B, S, nq, hd)
    k = _even_heads(dense(h, p["wk"], UP_W), nkv).reshape(B, S, nkv, hd)
    v = _even_heads(dense(h, p["wv"], UP_W), nkv).reshape(B, S, nkv, hd)
    # Decode replicates its one-token q and keeps the cache cut on its
    # sequence (flash-decode): q on heads against a sequence-cut cache
    # made the JAX package's partitioner gather the whole cache.
    q = constrain(q, ("batch", None, None, None) if ctx.mode == "decode"
                  else HEAD_AXES)
    k = constrain(k, KV_REPLICATED)
    v = constrain(v, KV_REPLICATED)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rotate(q, *ctx.rope)
    k = rotate(k, *ctx.rope)

    attend = attention if ctx.plain else ops.attention
    cache = ctx.cache
    if ctx.mode == "decode":
        pos = ctx.pos_offset
        write_rows(cache["k"], k, pos)          # in place (JAX: functional)
        write_rows(cache["v"], v, pos)
        # causal=False: decode ignores a local layer's window, as the JAX
        # package does (the window applies only with causal).
        o = attend(q, cache["k"], cache["v"], causal=False, window=ctx.window,
                   cap=cfg.attn_softcap, q_offset=pos, kv_len=pos + S)
    else:
        o = attend(q, k, v, causal=True, window=ctx.window,
                   cap=cfg.attn_softcap)
        if ctx.mode == "prefill":
            write_rows(cache["k"], k, 0)        # the rest stays zero
            write_rows(cache["v"], v, 0)
    o = _merge_heads(constrain(o, HEAD_AXES), nq)
    out = dense(o, p["wo"], DOWN_W)
    if cfg.post_norm:
        out = rms_norm(out, p["post_ln"], cfg.norm_eps)
    return out, cache


def _even_heads(t, n: int):
    """``t`` with dim 2 (n heads, or their n*hd values laid flat) cut only
    where the cut falls between heads into equal parts: DTensor splits and
    merges a cut dim only then.  Where the mesh dims that cut it do not
    divide n (llama's 8 KV heads over 16), they are gathered first; a
    plain tensor is returned as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    cut = [d for d, q in enumerate(t.placements) if q == Shard(2)]
    if n % math.prod(mesh.size(d) for d in cut) == 0:
        return t
    return t.redistribute(mesh, [Replicate() if d in cut else q
                                 for d, q in enumerate(t.placements)])


def _merge_heads(o, n: int):
    """(B, S, n, hd) -> (B, S, n*hd).  A DTensor whose heads are not cut
    (the rules' fallback, or ``_even_heads`` gathered them) is merged on
    its local tensor: the gradient then arrives cut on the merged dim by
    the projection after it, and is gathered before it is split back into
    heads, which DTensor's view would refuse where the cut does not fall
    between heads."""
    B, S, _, hd = o.shape
    o = _even_heads(o, n)
    if not is_dtensor(o) or any(q.is_shard(2) for q in o.placements):
        return o.reshape(B, S, n * hd)
    local = o.to_local(grad_placements=o.placements)
    return from_local(local.reshape(*local.shape[:2], n * hd),
                      o.device_mesh, o.placements, (B, S, n * hd))


def write_rows(cache: torch.Tensor, rows: torch.Tensor, pos: int) -> None:
    """``cache[:, pos:pos + S] = rows`` in place.  A DTensor cache (cut on
    its batch and sequence dims) takes on each rank the rows that fall in
    that rank's own shard, from ``rows`` placed as the cache on the batch
    dim: nothing is gathered, as the JAX package's
    ``dynamic_update_slice`` on the sharded cache gathers nothing."""
    S = rows.shape[1]
    if not is_dtensor(cache):
        cache[:, pos:pos + S] = rows
        return
    from torch.distributed.tensor import Replicate, Shard
    rows = rows.redistribute(cache.device_mesh, [
        p if p == Shard(0) else Replicate() for p in cache.placements])
    local, t0 = cache.to_local(), shard_offsets(cache)[1]
    lo, hi = max(pos, t0), min(pos + S, t0 + local.shape[1])
    if lo < hi:
        local[:, lo - t0:hi - t0] = rows.to_local()[:, lo - pos:hi - pos]


# ===========================================================================
# Mamba (selective SSM): Jamba's mixer
# ===========================================================================
def mamba_specs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    dt_rank = max(1, d // 16)
    return {
        "ln": PSpec((d,), (None,), init="zeros"),
        "w_in": PSpec((d, 2 * di), ("fsdp", "model")),
        "conv": PSpec((cfg.ssm_conv, di), (None, "model"), scale=0.1),
        "w_bcdt": PSpec((di, 2 * n + dt_rank), ("model", None)),
        "w_dt": PSpec((dt_rank, di), (None, "model"), scale=0.5),
        "dt_bias": PSpec((di,), ("model",), init="zeros"),
        "a_log": PSpec((di, n), ("model", None), init="zeros"),
        "d_skip": PSpec((di,), ("model",), init="ones"),
        "w_out": PSpec((di, d), ("model", "fsdp")),
    }


def mamba_cache_shape(cfg: ModelConfig, batch: int, _max_len: int):
    """The conv window in the activations' dtype; the SSM state fp32."""
    di = cfg.ssm_expand * cfg.d_model
    return {
        "conv": PSpec((batch, cfg.ssm_conv - 1, di), ("batch", None, "model"),
                      init="zeros"),
        "ssm": PSpec((batch, di, cfg.ssm_state), ("batch", "model", None),
                     init="zeros", dtype=torch.float32),
    }


def _ssm_scan(u, dt, a, b, c, h0):
    """Chunked selective scan (the plain version).  u,dt:(B,S,di)
    b,c:(B,S,N)  a:(di,N)  h0:(B,di,N).  Returns (y (B,S,di), h_last).

    As in the JAX package: the sequence is zero-padded to whole chunks of
    ``SSM_CHUNK`` (dt = 0 is the identity update) and a loop over chunks
    carries the (B,di,N) state; inside a chunk the linear recurrence
    h_t = Ā_t h_{t-1} + B̄_t u_t runs as an inclusive scan of the pairs
    (Ā, B̄) under (a_l, b_l)∘(a_r, b_r) = (a_l a_r, b_l a_r + b_r), here in
    log2(chunk) doubling steps where ``jax.lax.associative_scan`` takes
    another tree, so sums are rounded in another order.
    """
    B, S, di = u.shape
    n = a.shape[-1]
    c_len = min(SSM_CHUNK, S)
    n_chunks = -(-S // c_len)
    pad = n_chunks * c_len - S
    u_, dt_, b_, c_ = (F.pad(t, (0, 0, 0, pad)) for t in (u, dt, b, c))
    abar = torch.exp(dt_[..., None] * a)                       # (B,S',di,N)
    bbar = dt_[..., None] * b_[:, :, None, :] * u_[..., None]  # (B,S',di,N)
    h = h0
    ys = []
    for ci in range(n_chunks):
        sl = slice(ci * c_len, (ci + 1) * c_len)
        ab, bb = abar[:, sl], bbar[:, sl]                      # (B,c,di,N)
        shift = 1
        while shift < c_len:        # row t takes in row t - shift
            a_cur = ab[:, shift:]
            bb = torch.cat([bb[:, :shift],
                            bb[:, :-shift] * a_cur + bb[:, shift:]], dim=1)
            ab = torch.cat([ab[:, :shift], ab[:, :-shift] * a_cur], dim=1)
            shift *= 2
        hs = bb + ab * h[:, None]                              # (B,c,di,N)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, c_[:, sl]))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :S]
    return y, h


def mamba_apply(cfg: ModelConfig, p: Mapping[str, torch.Tensor], x,
                ctx: Ctx):
    B, S, D = x.shape
    di = cfg.ssm_expand * D
    n = cfg.ssm_state
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    xs, z = _halves(dense(h, p["w_in"], UP_W))                # (B,S,di)
    xs = constrain(xs, ("batch", None, "model"))

    # Causal conv1d over time (kernel ssm_conv).
    cache = ctx.cache
    prev = cache["conv"] if ctx.mode == "decode" else None
    conv = _conv_on_shards if is_dtensor(xs) else _causal_conv
    xc, new_conv = conv(xs, p["conv"], prev)
    xc = F.silu(xc)

    bcdt = dense(xc, p["w_bcdt"])
    b_in, c_in, dt_in = torch.split(bcdt, [n, n, bcdt.shape[-1] - 2 * n],
                                    dim=-1)
    dt = F.softplus(dense(dt_in, p["w_dt"]) + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())

    if ctx.mode == "decode":
        h0 = cache["ssm"]
    else:
        h0 = _zeros((B, di, n), ("batch", "model", None), x)
    u, dt, b_in, c_in = (t.float() for t in (xc, dt, b_in, c_in))
    # The kernel writes the state straight into the cache (each thread
    # reads its h0 before it writes it, so h0 may be that same tensor).
    scan = _ssm_scan if ctx.plain else ops.selective_scan
    out = None if ctx.plain or cache is None else cache["ssm"]
    if is_dtensor(u):
        y, h_last = ops.selective_scan_on_shards(scan, u, dt, a, b_in,
                                                 c_in, h0, out=out)
    else:
        y, h_last = scan(u, dt, a, b_in, c_in, h0,
                         **({} if out is None else {"out": out}))
    y = (y.to(x.dtype) + xc * p["d_skip"]) * F.silu(z)
    out = dense(y, p["w_out"], DOWN_W)
    if cache is not None and ctx.mode in ("decode", "prefill"):
        _store(cache["conv"], new_conv)
        if h_last is not cache["ssm"]:
            _store(cache["ssm"], h_last)
    return out, cache


def _causal_conv(xs, w, prev):
    """The causal depthwise conv over time: xs (B,S,di), w (K,di), prev
    the last K-1 rows before xs (the decode's conv cache) or None for
    zeros.  Returns (sum over i of xin[:, i:i+S] * w[i], the last K-1 rows
    of xin), xin being prev then xs."""
    K, S = w.shape[0], xs.shape[1]
    xin = F.pad(xs, (0, 0, K - 1, 0)) if prev is None else \
        torch.cat([prev, xs], dim=1)                         # (B,K-1+S,di)
    return (sum(xin[:, i:i + S] * w[i] for i in range(K)),
            xin[:, xin.shape[1] - (K - 1):])


def _conv_on_shards(xs, w, prev):
    """``_causal_conv`` on each rank's local shards of DTensors: per mesh
    dim, a block of the batch (w whole; its gradient a pending sum) or of
    the channels (w cut on di as xs is); xs whole on any other placement.
    The results are placed as the block xs was computed on."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = xs.device_mesh
    rows = []                   # per mesh dim: xs (and prev), w, w's grad
    for q in xs.placements:
        if q == Shard(0):
            rows.append((q, Replicate(), Partial()))
        elif q == Shard(2):
            rows.append((q, Shard(1), Shard(1)))
        else:
            rows.append((Replicate(),) * 3)
    xp, wp, wg = (list(r) for r in zip(*rows))
    xc, new = _causal_conv(
        xs.redistribute(mesh, xp).to_local(grad_placements=xp),
        frozen(w).redistribute(mesh, wp).to_local(grad_placements=wg),
        None if prev is None else prev.redistribute(mesh, xp).to_local())
    B, S, di = xs.shape
    return (from_local(xc, mesh, xp, xs.shape),
            from_local(new, mesh, xp, (B, w.shape[0] - 1, di)))


def _halves(t):
    """``t.chunk(2, dim=-1)``.  A DTensor cut on its last dim is made whole
    there first: each half would otherwise straddle the cut."""
    if is_dtensor(t) and any(q.is_shard(t.ndim - 1) for q in t.placements):
        from torch.distributed.tensor import Replicate
        t = t.redistribute(t.device_mesh, [
            Replicate() if q.is_shard(t.ndim - 1) else q
            for q in t.placements])
    return t.chunk(2, dim=-1)


def _zeros(shape, axes, like):
    """An fp32 zero state of ``shape`` beside the activations ``like``:
    for DTensor activations, a DTensor placed by the active rules for
    ``axes`` (the state's cache spec), holding only this rank's shard."""
    rules = current_rules() if is_dtensor(like) else None
    return struct(shape, torch.float32, rules, axes, device=like.device)


def _store(dst, src) -> None:
    """``dst.copy_(src)``, the cache write; a DTensor ``src`` is first
    redistributed to ``dst``'s placements, and each rank writes its own
    shard."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    dst.to_local().copy_(
        src.redistribute(dst.device_mesh, dst.placements).to_local())


# ===========================================================================
# xLSTM: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (recurrent)
# ===========================================================================
def mlstm_specs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d = cfg.d_model
    di = int(cfg.mlstm_proj_factor * d)
    return {
        "ln": PSpec((d,), (None,), init="zeros"),
        "w_up": PSpec((d, 2 * di), ("fsdp", "model")),
        "wq": PSpec((di, di), ("model", None)),
        "wk": PSpec((di, di), ("model", None)),
        "wv": PSpec((di, di), ("model", None)),
        "w_if": PSpec((di, 2 * cfg.n_heads), ("model", None), scale=0.1),
        "out_norm": PSpec((di,), ("model",), init="zeros"),
        "w_down": PSpec((di, d), ("model", "fsdp")),
    }


def mlstm_cache_shape(cfg: ModelConfig, batch: int, _max_len: int):
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    hd = di // cfg.n_heads
    return {
        "C": PSpec((batch, cfg.n_heads, hd, hd), ("batch", None, None, None),
                   init="zeros", dtype=torch.float32),
        "n": PSpec((batch, cfg.n_heads, hd), ("batch", None, None),
                   init="zeros", dtype=torch.float32),
    }


def _mlstm_cell(q, k, v, i_gate, f_gate, c0, n0):
    """Chunkwise-parallel gated linear attention (the plain version).

    q,k,v: (B,S,H,hd)   i,f: (B,S,H) in (0,1)   c0: (B,H,hd,hd)
    n0: (B,H,hd).  Returns (y (B,S,H,hd), c_last, n_last).  Decays stay in
    log space so chunk ratios never overflow.  As in the JAX cell, a ragged
    tail is zero-padded, f included, so when S is above the chunk and not a
    multiple of it each padded row decays the returned state by 1e-8 (y is
    unaffected; ROADMAP Queue 3).  The kernel pads with f = 1, so
    ``mlstm_apply`` applies that decay to the kernel's state itself.  The
    masked entries' decay is never exponentiated, so the gradient stays
    finite where the JAX cell's is NaN (at full width, ROADMAP "Deliberate
    divergences"); the values are the JAX cell's.
    """
    B, S, H, hd = q.shape
    c_len = min(MLSTM_CHUNK, S)
    n_chunks = -(-S // c_len)
    pad = n_chunks * c_len - S
    # Zero-pad the sequence dim at the end, as ``jnp.pad`` does.
    q, k, v, i_gate, f_gate = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                               for t in (q, k, v, i_gate, f_gate))
    scale = 1.0 / math.sqrt(hd)
    mask = torch.ones((c_len, c_len), dtype=torch.bool,
                      device=q.device).tril()[None, :, :, None]
    c_state, n_state = c0, n0
    ys = []
    for c in range(n_chunks):
        sl = slice(c * c_len, (c + 1) * c_len)
        qb, kb, vb, ib, fb = (t[:, sl] for t in (q, k, v, i_gate, f_gate))
        qb = qb * scale
        cum = torch.cumsum(torch.log(fb + 1e-8), dim=1)   # (B,c,H) ≤ 0
        # inter-chunk: decay_t · q_t C_prev
        y_inter = torch.einsum("bshd,bhde->bshe", qb, c_state) * \
            torch.exp(cum)[..., None]
        # intra-chunk: masked scores with decay ratio exp(cum_t - cum_s)·i_s
        # The masked (s > t) ratios are -inf before the exp, where the JAX
        # cell takes where(mask, exp(ratio), 0): the same values, but a
        # masked ratio above fp32's exp range there is inf, and the
        # backward's 0 · inf makes the gradient NaN.
        ratio = cum[:, :, None, :] - cum[:, None, :, :]      # (B,t,s,H)
        w = torch.exp(ratio.masked_fill(~mask, -math.inf))
        sc = torch.einsum("bshd,bthd->bsth", qb, kb)
        y_intra = torch.einsum("bsth,bthd->bshd", sc * w * ib[:, None], vb)
        # state: C = A·C + Σ_s exp(cum_c - cum_s)·i_s k_s v_sᵀ
        rem = torch.exp(cum[:, -1:] - cum) * ib                # (B,c,H)
        decay = torch.exp(cum[:, -1])                          # (B,H)
        c_state = c_state * decay[..., None, None] + torch.einsum(
            "bshd,bshe->bhde", kb * rem[..., None], vb)
        n_state = n_state * decay[..., None] + torch.einsum(
            "bshd,bsh->bhd", kb, rem)
        ys.append(y_inter + y_intra)
    y = torch.cat(ys, dim=1)[:, :S]
    return y, c_state, n_state


def mlstm_apply(cfg: ModelConfig, p: Mapping[str, torch.Tensor], x,
                ctx: Ctx):
    B, S, D = x.shape
    H = cfg.n_heads
    di = int(cfg.mlstm_proj_factor * D)
    hd = di // H
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    up, z = _halves(dense(h, p["w_up"], UP_W))
    q = dense(up, p["wq"]).reshape(B, S, H, hd)
    k = dense(up, p["wk"]).reshape(B, S, H, hd) / math.sqrt(hd)
    v = dense(up, p["wv"]).reshape(B, S, H, hd)
    gates = dense(up, p["w_if"]).reshape(B, S, H, 2)
    i_gate = torch.sigmoid(gates[..., 0])
    f_gate = torch.sigmoid(gates[..., 1] + 3.0)  # bias toward remembering
    cache = ctx.cache
    if ctx.mode == "decode":
        c0, n0 = cache["C"], cache["n"]
    else:
        c0 = _zeros((B, H, hd, hd), ("batch", None, None, None), x)
        n0 = _zeros((B, H, hd), ("batch", None, None), x)
    q, k, v, i_gate, f_gate = (t.float() for t in (q, k, v, i_gate, f_gate))
    # The kernel writes C and n straight into the cache (each block reads
    # its slab of c0 and n0 before it writes it, so the inputs may be
    # those same tensors).
    cell = _mlstm_cell if ctx.plain else ops.mlstm
    outs = {} if ctx.plain or cache is None else {"out": cache["C"],
                                                  "n_out": cache["n"]}
    if is_dtensor(q):
        y, c_last, n_last = ops.mlstm_on_shards(cell, q, k, v, i_gate,
                                                f_gate, c0, n0, **outs)
    else:
        y, c_last, n_last = cell(q, k, v, i_gate, f_gate, c0, n0=n0, **outs)
    if not ctx.plain and S > MLSTM_CHUNK and S % MLSTM_CHUNK:
        # The JAX cell pads the ragged tail with f = 0: each padded row
        # decays C and n by log(1e-8), which the kernel (f = 1 padding,
        # the identity) does not do.  Apply the same decay here, to each
        # rank's shard.
        pad = MLSTM_CHUNK - S % MLSTM_CHUNK
        wipe = math.exp(pad * math.log(float(torch.tensor(1e-8))))
        for t in (c_last, n_last):
            (t.to_local() if is_dtensor(t) else t).mul_(wipe)
    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps) * F.silu(z)
    out = dense(y, p["w_down"], DOWN_W)
    if cache is not None and ctx.mode in ("decode", "prefill"):
        if c_last is not cache["C"]:
            _store(cache["C"], c_last)
        if n_last is not cache["n"]:
            _store(cache["n"], n_last)
    return out, cache


def slstm_specs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d = cfg.d_model
    fh = int(cfg.slstm_proj_factor * d)
    hd = d // cfg.n_heads
    return {
        "ln": PSpec((d,), (None,), init="zeros"),
        "w_gates": PSpec((d, 4 * d), ("fsdp", "model")),
        "r_gates": PSpec((cfg.n_heads, hd, 4 * hd), (None, None, None),
                         scale=0.3),
        "ln_ff": PSpec((d,), (None,), init="zeros"),
        "w_ff1": PSpec((d, fh), ("fsdp", "model")),
        "w_ff2": PSpec((fh, d), ("model", "fsdp")),
    }


def slstm_cache_shape(cfg: ModelConfig, batch: int, _max_len: int):
    return {n: PSpec((batch, cfg.d_model), ("batch", "model"), init="zeros",
                     dtype=torch.float32)
            for n in ("c", "n", "h", "m")}


def slstm_apply(cfg: ModelConfig, p: Mapping[str, torch.Tensor], x,
                ctx: Ctx):
    """Recurrent scalar-memory cell, one eager step per token (it has no
    TPU kernel).  Copied exactly, quirks included: the recurrent term is
    reshaped from (B,H,4·hd) to (B,4D) before the gate split, so gates mix
    heads; the FFN's gelu is the tanh approximation (``jax.nn.gelu``'s
    default); the block returns ``out + f - x`` and the LM adds x back.
    On DTensors the time loop runs on each rank's batch shard of the gate
    inputs, whole on 4D (``_slstm_on_shards``)."""
    B, S, D = x.shape
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    gx = dense(xin, p["w_gates"], UP_W).float()                # (B,S,4D)
    cache = ctx.cache
    state0 = None
    if ctx.mode == "decode" and cache is not None:
        state0 = tuple(cache[k] for k in ("c", "n", "h", "m"))
    loop = _slstm_on_shards if is_dtensor(gx) else _slstm_loop
    y, state = loop(gx, state0, p["r_gates"].float(), cfg.n_heads)
    out = x + y.to(x.dtype)
    # feed-forward sub-block
    f = rms_norm(out, p["ln_ff"], cfg.norm_eps)
    f = dense(F.gelu(dense(f, p["w_ff1"], UP_W), approximate="tanh"),
              p["w_ff2"], DOWN_W)
    if cache is not None and ctx.mode in ("decode", "prefill"):
        for name, t in zip(("c", "n", "h", "m"), state):
            _store(cache[name], t)
    return out + f - x, cache  # block returns delta (residual added by LM)


def _slstm_loop(gx, state0, r, H: int):
    """The sLSTM time loop on plain tensors: gx (B,S,4D) fp32, state0 the
    (c, n, h, m) of (B, D) or None for zeros, r (H, hd, 4·hd).  Returns
    (y (B,S,D) fp32, the final (c, n, h, m))."""
    B, S, D4 = gx.shape
    D = D4 // 4
    hd = D // H
    if state0 is None:
        c, n, hprev, m = (torch.zeros((B, D), dtype=torch.float32,
                                      device=gx.device) for _ in range(4))
    else:
        c, n, hprev, m = (t.float() for t in state0)
    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,hde->bhe", hprev.reshape(B, H, hd),
                           r).reshape(B, 4 * D)
        it, ft, zt, ot = (gx[:, t] + rec).chunk(4, dim=-1)
        m_new = torch.maximum(ft + m, it)          # exp-gate stabilizer
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(ft + m - m_new)
        c = f_ * c + i_ * torch.tanh(zt)
        n = f_ * n + i_
        hprev = torch.sigmoid(ot) * c / torch.clamp_min(n, 1.0)
        m = m_new
        hs.append(hprev)
    return torch.stack(hs, dim=1), (c, n, hprev, m)


def _slstm_on_shards(gx, state0, r, H: int):
    """``_slstm_loop`` on DTensors, run on each rank's local tensors: per
    mesh dim, the block of the batch that gx holds, else the whole batch;
    gx whole on 4D (the gate split crosses any cut there), r whole.  The
    loop issues no collective and runs no DTensor op per token.  Returns
    y and the final state as DTensors placed as that batch block; r's
    gradient is a pending sum over the mesh dims that cut the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = gx.device_mesh
    rows = [q if q == Shard(0) else Replicate() for q in gx.placements]
    rgrad = [Partial() if q == Shard(0) else q for q in rows]
    B, S, D4 = gx.shape
    gxl = gx.redistribute(mesh, rows).to_local(grad_placements=rows)
    rl = frozen(r).redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=rgrad)
    if state0 is not None:
        state0 = tuple(t.redistribute(mesh, rows).to_local()
                       for t in state0)
    y, state = _slstm_loop(gxl, state0, rl, H)
    return (from_local(y, mesh, rows, (B, S, D4 // 4)),
            tuple(from_local(t, mesh, rows, (B, D4 // 4)) for t in state))


# ===========================================================================
# FFN / MoE
# ===========================================================================
def ffn_specs(cfg: ModelConfig, is_moe: bool) -> Dict[str, Any]:
    """{name: PSpec}; an MoE layer nests its specs under ``moe``."""
    d = cfg.d_model
    s: Dict[str, Any] = {"ln": PSpec((d,), (None,), init="zeros")}
    if is_moe:
        s["moe"] = moe_specs(cfg)
    else:
        s.update({
            "w_gate": PSpec((d, cfg.d_ff), ("fsdp", "model")),
            "w_up": PSpec((d, cfg.d_ff), ("fsdp", "model")),
            "w_down": PSpec((cfg.d_ff, d), ("model", "fsdp")),
        })
    if cfg.post_norm:
        s["post_ln"] = PSpec((d,), (None,), init="zeros")
    return s


def ffn_apply(cfg: ModelConfig, p: Mapping[str, Any], x, is_moe: bool,
              layer: int = -1):
    """Returns (out, aux): the router's aux loss for an MoE layer, else 0.
    A dense FFN runs in the span ``repro_torch.ffn``, an MoE's in
    ``moe_apply``'s ``repro_torch.moe``."""
    with obs.OFF if is_moe else obs.span("ffn", layer=layer):
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        if is_moe:
            out, aux = moe_apply(cfg, p["moe"], h, layer=layer)
        else:
            out, aux = swiglu(h, p["w_gate"], p["w_up"], p["w_down"]), 0.0
        if cfg.post_norm:
            out = rms_norm(out, p["post_ln"], cfg.norm_eps)
    return out, aux


# ===========================================================================
# Kind registry
# ===========================================================================
MIXERS = {
    "attn": (attn_specs, attn_apply, attn_cache_shape),
    "attn_local": (attn_specs, attn_apply, attn_cache_shape),
    "mamba": (mamba_specs, mamba_apply, mamba_cache_shape),
    "mlstm": (mlstm_specs, mlstm_apply, mlstm_cache_shape),
    "slstm": (slstm_specs, slstm_apply, slstm_cache_shape),
}


def mixer(kind: str):
    return MIXERS[kind]


def layer_specs(cfg: ModelConfig, layer_idx: int) -> Dict[str, Any]:
    kind = cfg.full_pattern[layer_idx]
    specs = {"mixer": mixer(kind)[0](cfg)}
    if kind in FFN_KINDS and (cfg.d_ff > 0 or cfg.is_moe_layer(layer_idx)):
        specs["ffn"] = ffn_specs(cfg, cfg.is_moe_layer(layer_idx))
    return specs


def layer_apply(cfg: ModelConfig, kind: str, is_moe: bool, params, x,
                ctx: Ctx, layer: int = -1):
    """One full layer: mixer + optional FFN, with residuals.  The mixer
    runs in the span of its kind (``repro_torch.attn`` for both attention
    kinds), ``layer`` its index."""
    with obs.span("attn" if kind in ATTN_KINDS else kind, layer=layer):
        mix_out, cache = mixer(kind)[1](cfg, params["mixer"], x, ctx)
    x = x + _scaled(mix_out, cfg.residual_scale)
    aux = 0.0
    if "ffn" in params:
        ffn_out, aux = ffn_apply(cfg, params["ffn"], x, is_moe, layer)
        x = x + _scaled(ffn_out, cfg.residual_scale)
    # "seq" maps to the TP axis only under the sp profile.
    return constrain(x, ("batch", "seq", None)), cache, aux


def _scaled(x, scale: float):
    # x * 1.0 is x: skipping it saves a launch per residual in eager mode.
    return x if scale == 1.0 else x * scale
