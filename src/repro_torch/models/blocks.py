"""Decoder blocks: the port of ``repro.models.blocks`` for the ``attn`` kind
with a dense FFN.

Every kind implements
  specs(cfg)                    -> {name: PSpec} for one layer
  apply(cfg, params, x, ctx)    -> (x_out, cache)
with ``ctx`` carrying the mode ("train" | "prefill" | "decode"), the rope
tables, the window and the layer's cache.

The JAX package updates the KV cache functionally and returns a new one.
The port writes into a preallocated ``(B, T, Nkv, hd)`` cache in place: the
prefill writes the prompt's K/V at ``[:, :S]`` of a zeroed cache (the JAX
package pads to ``max_len``), a decode step writes at ``[:, pos:pos+S]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

import torch

from ..kernels import ops
from .config import ModelConfig
from .layers import PSpec, attention, dense, rms_norm, rotate, swiglu

# Where each block kind the port does not run yet is queued.
_NOT_PORTED = {
    "attn_local": "ROADMAP Queue 1 item 3 (local attention, gemma)",
    "mamba": "ROADMAP Queue 1 item 5 (Mamba, mamba_scan)",
    "mlstm": "ROADMAP Queue 1 item 6 (xLSTM, mlstm_scan)",
    "slstm": "ROADMAP Queue 1 item 6 (xLSTM, mlstm_scan)",
    "moe": "ROADMAP Queue 1 item 4 (MoE)",
    "mrope": "ROADMAP Queue 1 item 7 (other input modes, M-RoPE)",
}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: {_NOT_PORTED[what]}")


@dataclass
class Ctx:
    mode: str                       # train | prefill | decode
    # (cos, sin) of the positions at the layer's rope theta
    # (layers.rope_cos_sin).  The JAX Ctx carries positions and theta and
    # every layer recomputes the angles; here the LM computes them once per
    # pass, which saves launches and gives the same numbers.
    rope: Tuple[torch.Tensor, torch.Tensor]
    window: int = 0                 # 0 = global attention
    cache: Any = None               # layer cache {"k","v"}: (B,T,Nkv,hd)
    pos_offset: int = 0             # absolute position of x[0]
    max_len: int = 0                # cache capacity
    plain: bool = False             # plain attention instead of the kernels


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
# FFN
# ===========================================================================
def ffn_specs(cfg: ModelConfig, is_moe: bool) -> Dict[str, PSpec]:
    if is_moe:
        raise not_ported("moe")
    d = cfg.d_model
    s = {
        "ln": PSpec((d,), init="zeros"),
        "w_gate": PSpec((d, cfg.d_ff)),
        "w_up": PSpec((d, cfg.d_ff)),
        "w_down": PSpec((cfg.d_ff, d)),
    }
    if cfg.post_norm:
        s["post_ln"] = PSpec((d,), init="zeros")
    return s


def ffn_apply(cfg: ModelConfig, p: Mapping[str, torch.Tensor], x,
              is_moe: bool):
    if is_moe:
        raise not_ported("moe")
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    out = swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    if cfg.post_norm:
        out = rms_norm(out, p["post_ln"], cfg.norm_eps)
    return out, 0.0


# ===========================================================================
# Kind registry
# ===========================================================================
MIXERS = {"attn": (attn_specs, attn_apply, attn_cache_shape)}


def mixer(kind: str):
    if kind not in MIXERS:
        raise not_ported(kind)
    return MIXERS[kind]


def layer_specs(cfg: ModelConfig, layer_idx: int) -> Dict[str, Any]:
    kind = cfg.full_pattern[layer_idx]
    specs = {"mixer": mixer(kind)[0](cfg)}
    if cfg.d_ff > 0 or cfg.is_moe_layer(layer_idx):
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
