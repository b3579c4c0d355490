"""Decoder blocks: the port of ``repro.models.blocks`` for the ``attn``
kind, the ``mamba`` kind, the xLSTM kinds ``mlstm`` and ``slstm``, and the
FFN, dense or MoE.

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
tensor instead would leave the cache as it was.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import PSpec, attention, dense, rms_norm, rotate, swiglu
from .moe import moe_apply, moe_specs

SSM_CHUNK = 64      # mamba: tokens per associative-scan chunk (plain scan)
MLSTM_CHUNK = 256   # mLSTM: chunkwise-parallel block size of the plain cell

ATTN_KINDS = ("attn", "attn_local")
FFN_KINDS = ATTN_KINDS + ("mamba",)     # the kinds that carry an FFN

# Where each block kind the port does not run yet is queued.
_NOT_PORTED = {
    "attn_local": "ROADMAP Queue 1 item 5 (local attention, gemma)",
    "mrope": "ROADMAP Queue 1 item 6 (other input modes, M-RoPE)",
    "compress": "ROADMAP Queue 1 item 8 (optim/compress.py, int8 "
                "gradients)",
}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: {_NOT_PORTED[what]}")


@dataclass
class Ctx:
    mode: str                       # train | prefill | decode
    # (cos, sin) of the positions at the layer's rope theta
    # (layers.rope_cos_sin), None when the model has no attention.  The JAX
    # Ctx carries positions and theta and every layer recomputes the
    # angles; here the LM computes them once per pass, which saves launches
    # and gives the same numbers.
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    window: int = 0                 # 0 = global attention
    cache: Any = None               # the layer's cache dict (views, in place)
    pos_offset: int = 0             # absolute position of x[0]
    max_len: int = 0                # cache capacity
    plain: bool = False             # plain PyTorch instead of the kernels


# ===========================================================================
# Attention
# ===========================================================================
def attn_specs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    s = {
        "ln": PSpec((d,), init="zeros"),
        "wq": PSpec((d, nq * hd)),
        "wk": PSpec((d, nkv * hd)),
        "wv": PSpec((d, nkv * hd)),
        "wo": PSpec((nq * hd, d)),
    }
    if cfg.qk_norm:
        s["q_norm"] = PSpec((hd,), init="zeros")
        s["k_norm"] = PSpec((hd,), init="zeros")
    if cfg.post_norm:
        s["post_ln"] = PSpec((d,), init="zeros")
    return s


def attn_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": PSpec(shape, init="zeros"), "v": PSpec(shape, init="zeros")}


def attn_apply(cfg: ModelConfig, p: Mapping[str, torch.Tensor], x, ctx: Ctx):
    if cfg.mrope:
        raise not_ported("mrope")
    B, S, _ = x.shape
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = dense(h, p["wq"]).reshape(B, S, nq, hd)
    k = dense(h, p["wk"]).reshape(B, S, nkv, hd)
    v = dense(h, p["wv"]).reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rotate(q, *ctx.rope)
    k = rotate(k, *ctx.rope)

    attend = attention if ctx.plain else ops.attention
    cache = ctx.cache
    if ctx.mode == "decode":
        pos = ctx.pos_offset
        cache["k"][:, pos:pos + S] = k          # in place (JAX: functional)
        cache["v"][:, pos:pos + S] = v
        o = attend(q, cache["k"], cache["v"], causal=False, window=ctx.window,
                   cap=cfg.attn_softcap, q_offset=pos, kv_len=pos + S)
    else:
        o = attend(q, k, v, causal=True, window=ctx.window,
                   cap=cfg.attn_softcap)
        if ctx.mode == "prefill":
            cache["k"][:, :S] = k               # the rest stays zero
            cache["v"][:, :S] = v
    out = dense(o.reshape(B, S, nq * hd), p["wo"])
    if cfg.post_norm:
        out = rms_norm(out, p["post_ln"], cfg.norm_eps)
    return out, cache


# ===========================================================================
# Mamba (selective SSM): Jamba's mixer
# ===========================================================================
def mamba_specs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    dt_rank = max(1, d // 16)
    return {
        "ln": PSpec((d,), init="zeros"),
        "w_in": PSpec((d, 2 * di)),
        "conv": PSpec((cfg.ssm_conv, di), scale=0.1),
        "w_bcdt": PSpec((di, 2 * n + dt_rank)),
        "w_dt": PSpec((dt_rank, di), scale=0.5),
        "dt_bias": PSpec((di,), init="zeros"),
        "a_log": PSpec((di, n), init="zeros"),
        "d_skip": PSpec((di,), init="ones"),
        "w_out": PSpec((di, d)),
    }


def mamba_cache_shape(cfg: ModelConfig, batch: int, _max_len: int):
    """The conv window in the activations' dtype; the SSM state fp32."""
    di = cfg.ssm_expand * cfg.d_model
    return {
        "conv": PSpec((batch, cfg.ssm_conv - 1, di), init="zeros"),
        "ssm": PSpec((batch, di, cfg.ssm_state), init="zeros",
                     dtype=torch.float32),
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
    K = cfg.ssm_conv
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    xs, z = dense(h, p["w_in"]).chunk(2, dim=-1)               # (B,S,di)

    # Causal conv1d over time (kernel ssm_conv).
    cache = ctx.cache
    if ctx.mode == "decode":
        xin = torch.cat([cache["conv"], xs], dim=1)            # (B,K-1+S,di)
    else:
        xin = F.pad(xs, (0, 0, K - 1, 0))
    new_conv = xin[:, xin.shape[1] - (K - 1):]
    xc = sum(xin[:, i:i + S] * p["conv"][i] for i in range(K))
    xc = F.silu(xc)

    bcdt = dense(xc, p["w_bcdt"])
    b_in, c_in, dt_in = torch.split(bcdt, [n, n, bcdt.shape[-1] - 2 * n],
                                    dim=-1)
    dt = F.softplus(dense(dt_in, p["w_dt"]) + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())

    if ctx.mode == "decode":
        h0 = cache["ssm"]
    else:
        h0 = torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
    u, dt, b_in, c_in = (t.float() for t in (xc, dt, b_in, c_in))
    if ctx.plain:
        y, h_last = _ssm_scan(u, dt, a, b_in, c_in, h0)
    else:
        # The kernel writes the state straight into the cache (each thread
        # reads its h0 before it writes it, so h0 may be that same tensor).
        y, h_last = ops.selective_scan(
            u, dt, a, b_in, c_in, h0,
            out=None if cache is None else cache["ssm"])
    y = (y.to(x.dtype) + xc * p["d_skip"]) * F.silu(z)
    out = dense(y, p["w_out"])
    if cache is not None and ctx.mode in ("decode", "prefill"):
        cache["conv"].copy_(new_conv)
        if h_last is not cache["ssm"]:
            cache["ssm"].copy_(h_last)
    return out, cache


# ===========================================================================
# xLSTM: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (recurrent)
# ===========================================================================
def mlstm_specs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d = cfg.d_model
    di = int(cfg.mlstm_proj_factor * d)
    return {
        "ln": PSpec((d,), init="zeros"),
        "w_up": PSpec((d, 2 * di)),
        "wq": PSpec((di, di)),
        "wk": PSpec((di, di)),
        "wv": PSpec((di, di)),
        "w_if": PSpec((di, 2 * cfg.n_heads), scale=0.1),
        "out_norm": PSpec((di,), init="zeros"),
        "w_down": PSpec((di, d)),
    }


def mlstm_cache_shape(cfg: ModelConfig, batch: int, _max_len: int):
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    hd = di // cfg.n_heads
    return {
        "C": PSpec((batch, cfg.n_heads, hd, hd), init="zeros",
                   dtype=torch.float32),
        "n": PSpec((batch, cfg.n_heads, hd), init="zeros",
                   dtype=torch.float32),
    }


def _mlstm_cell(q, k, v, i_gate, f_gate, c0, n0):
    """Chunkwise-parallel gated linear attention (the plain version).

    q,k,v: (B,S,H,hd)   i,f: (B,S,H) in (0,1)   c0: (B,H,hd,hd)
    n0: (B,H,hd).  Returns (y (B,S,H,hd), c_last, n_last).  Decays stay in
    log space so chunk ratios never overflow.  As in the JAX cell, a ragged
    tail is zero-padded, f included, so when S is above the chunk and not a
    multiple of it each padded row decays the returned state by 1e-8 (y is
    unaffected; ROADMAP Queue 3).  The kernel pads with f = 1, so
    ``mlstm_apply`` applies that decay to the kernel's state itself.
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
        ratio = cum[:, :, None, :] - cum[:, None, :, :]      # (B,t,s,H)
        w = torch.where(mask, torch.exp(ratio), torch.zeros_like(ratio))
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
    up, z = dense(h, p["w_up"]).chunk(2, dim=-1)
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
        c0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        n0 = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    q, k, v, i_gate, f_gate = (t.float() for t in (q, k, v, i_gate, f_gate))
    if ctx.plain:
        y, c_last, n_last = _mlstm_cell(q, k, v, i_gate, f_gate, c0, n0)
    else:
        # The kernel writes C and n straight into the cache (each block
        # reads its slab of c0 and n0 before it writes it, so the inputs
        # may be those same tensors).
        y, c_last, n_last = ops.mlstm(
            q, k, v, i_gate, f_gate, c0, n0=n0,
            out=None if cache is None else cache["C"],
            n_out=None if cache is None else cache["n"])
        if S > MLSTM_CHUNK and S % MLSTM_CHUNK:
            # The JAX cell pads the ragged tail with f = 0: each padded row
            # decays C and n by log(1e-8), which the kernel (f = 1 padding,
            # the identity) does not do.  Apply the same decay here.
            pad = MLSTM_CHUNK - S % MLSTM_CHUNK
            wipe = math.exp(pad * math.log(float(torch.tensor(1e-8))))
            c_last.mul_(wipe)
            n_last.mul_(wipe)
    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps) * F.silu(z)
    out = dense(y, p["w_down"])
    if cache is not None and ctx.mode in ("decode", "prefill"):
        if c_last is not cache["C"]:
            cache["C"].copy_(c_last)
        if n_last is not cache["n"]:
            cache["n"].copy_(n_last)
    return out, cache


def slstm_specs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d = cfg.d_model
    fh = int(cfg.slstm_proj_factor * d)
    hd = d // cfg.n_heads
    return {
        "ln": PSpec((d,), init="zeros"),
        "w_gates": PSpec((d, 4 * d)),
        "r_gates": PSpec((cfg.n_heads, hd, 4 * hd), scale=0.3),
        "ln_ff": PSpec((d,), init="zeros"),
        "w_ff1": PSpec((d, fh)),
        "w_ff2": PSpec((fh, d)),
    }


def slstm_cache_shape(cfg: ModelConfig, batch: int, _max_len: int):
    return {n: PSpec((batch, cfg.d_model), init="zeros", dtype=torch.float32)
            for n in ("c", "n", "h", "m")}


def slstm_apply(cfg: ModelConfig, p: Mapping[str, torch.Tensor], x,
                ctx: Ctx):
    """Recurrent scalar-memory cell, one eager step per token (it has no
    TPU kernel).  Copied exactly, quirks included: the recurrent term is
    reshaped from (B,H,4·hd) to (B,4D) before the gate split, so gates mix
    heads; the FFN's gelu is the tanh approximation (``jax.nn.gelu``'s
    default); the block returns ``out + f - x`` and the LM adds x back."""
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    gx = dense(xin, p["w_gates"]).float()                      # (B,S,4D)
    cache = ctx.cache
    if ctx.mode == "decode" and cache is not None:
        c, n, hprev, m = (cache[k].float() for k in ("c", "n", "h", "m"))
    else:
        c, n, hprev, m = (torch.zeros((B, D), dtype=torch.float32,
                                      device=x.device) for _ in range(4))
    r = p["r_gates"].float()
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
    y = torch.stack(hs, dim=1).to(x.dtype)                    # (B,S,D)
    out = x + y
    # feed-forward sub-block
    f = rms_norm(out, p["ln_ff"], cfg.norm_eps)
    f = dense(F.gelu(dense(f, p["w_ff1"]), approximate="tanh"), p["w_ff2"])
    if cache is not None and ctx.mode in ("decode", "prefill"):
        for name, t in zip(("c", "n", "h", "m"), (c, n, hprev, m)):
            cache[name].copy_(t)
    return out + f - x, cache  # block returns delta (residual added by LM)


# ===========================================================================
# FFN / MoE
# ===========================================================================
def ffn_specs(cfg: ModelConfig, is_moe: bool) -> Dict[str, Any]:
    """{name: PSpec}; an MoE layer nests its specs under ``moe``."""
    d = cfg.d_model
    s: Dict[str, Any] = {"ln": PSpec((d,), init="zeros")}
    if is_moe:
        s["moe"] = moe_specs(cfg)
    else:
        s.update({
            "w_gate": PSpec((d, cfg.d_ff)),
            "w_up": PSpec((d, cfg.d_ff)),
            "w_down": PSpec((cfg.d_ff, d)),
        })
    if cfg.post_norm:
        s["post_ln"] = PSpec((d,), init="zeros")
    return s


def ffn_apply(cfg: ModelConfig, p: Mapping[str, Any], x, is_moe: bool):
    """Returns (out, aux): the router's aux loss for an MoE layer, else 0."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if is_moe:
        out, aux = moe_apply(cfg, p["moe"], h)
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
    "mamba": (mamba_specs, mamba_apply, mamba_cache_shape),
    "mlstm": (mlstm_specs, mlstm_apply, mlstm_cache_shape),
    "slstm": (slstm_specs, slstm_apply, slstm_cache_shape),
}


def mixer(kind: str):
    if kind not in MIXERS:
        raise not_ported(kind)
    return MIXERS[kind]


def layer_specs(cfg: ModelConfig, layer_idx: int) -> Dict[str, Any]:
    kind = cfg.full_pattern[layer_idx]
    specs = {"mixer": mixer(kind)[0](cfg)}
    if kind in FFN_KINDS and (cfg.d_ff > 0 or cfg.is_moe_layer(layer_idx)):
        specs["ffn"] = ffn_specs(cfg, cfg.is_moe_layer(layer_idx))
    return specs


def layer_apply(cfg: ModelConfig, kind: str, is_moe: bool, params, x,
                ctx: Ctx):
    """One full layer: mixer + optional FFN, with residuals."""
    mix_out, cache = mixer(kind)[1](cfg, params["mixer"], x, ctx)
    x = x + _scaled(mix_out, cfg.residual_scale)
    aux = 0.0
    if "ffn" in params:
        ffn_out, aux = ffn_apply(cfg, params["ffn"], x, is_moe)
        x = x + _scaled(ffn_out, cfg.residual_scale)
    return x, cache, aux


def _scaled(x, scale: float):
    # x * 1.0 is x: skipping it saves a launch per residual in eager mode.
    return x if scale == 1.0 else x * scale
