"""Mixture-of-Experts, single shard (port of ``repro.models.moe``).

The JAX package's sort-based dispatch, copied: the router's top-k
assignments are ranked within their expert by a stable sort, scattered into
per-expert capacity buffers (assignments past an expert's capacity are
dropped, and the drops are part of the function), run through every
expert's SwiGLU as three batched products, and combined back with the fp32
gates.  The result is cast back to the activations' dtype.

The JAX package's expert-parallel path (``_moe_shardmap``: all-to-all over
a mesh) is not ported: ``moe_apply`` always takes the single-shard branch.
Nothing here syncs the host: the kept rows are selected by index
arithmetic, never by a boolean mask.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import PSpec, dense


def moe_specs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, e = cfg.d_model, cfg.n_experts
    f = cfg.expert_d_ff or cfg.d_ff
    specs = {
        "router": PSpec((d, e), scale=1.0 / math.sqrt(d)),
        "w_gate": PSpec((e, d, f)),
        "w_up": PSpec((e, d, f)),
        "w_down": PSpec((e, f, d)),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        specs.update({
            "ws_gate": PSpec((d, fs)),
            "ws_up": PSpec((d, fs)),
            "ws_down": PSpec((fs, d)),
        })
    return specs


def _expert_ffn(w: Mapping[str, torch.Tensor], tokens: torch.Tensor):
    """tokens: (E, C, D) -> (E, C, D), every expert's SwiGLU."""
    h = F.silu(torch.bmm(tokens, w["w_gate"])) * torch.bmm(tokens, w["w_up"])
    return torch.bmm(h, w["w_down"])


def _route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """x: (T, D) -> gates (T, k) fp32, expert ids (T, k), aux loss scalar."""
    logits = dense(x, router_w).float()                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance aux: E * Σ_e mean_load_e * mean_prob_e
    e = cfg.n_experts
    load = torch.zeros((e,), dtype=torch.float32, device=x.device)
    load = load.index_add_(0, ids.reshape(-1),
                           torch.ones(ids.numel(), device=x.device))
    load = load / load.sum().clamp_min(1.0)
    aux = e * torch.sum(load * probs.mean(0))
    return gates, ids, aux


def _fill_capacity_buffers(x, gates, ids, n_experts: int, capacity: int):
    """Scatter (T,D) tokens into (E, C, D) buffers, dropping overflow.

    Returns the buffers, plus (slot, keep) to invert the scatter at
    combine.  A dropped assignment's slot is the overflow row E·C, as in
    the JAX package.
    """
    t, k = ids.shape
    flat_ids = ids.reshape(-1)                                 # (T*k,)
    # Rank of each assignment within its expert, computed via sort.
    order = torch.sort(flat_ids, stable=True).indices
    sorted_ids = flat_ids[order]
    seg_start = torch.searchsorted(
        sorted_ids, torch.arange(n_experts, device=x.device))
    pos_sorted = torch.arange(t * k, device=x.device) - seg_start[sorted_ids]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < capacity
    slot = torch.where(keep, flat_ids * capacity + pos,
                       torch.full_like(pos, n_experts * capacity))
    src = x.repeat_interleave(k, dim=0)                        # (T*k, D)
    buf = torch.zeros((n_experts * capacity + 1, x.shape[-1]),
                      dtype=x.dtype, device=x.device)
    buf[slot] = torch.where(keep[:, None], src, torch.zeros_like(src))
    return buf[:-1].reshape(n_experts, capacity, -1), slot, keep


def _combine(expert_out, slot, keep, gates, t: int, k: int):
    """Gather (E,C,D) outputs back to (T, D) with top-k gate weighting; the
    gates stay fp32 for the sum, the result takes the activations' dtype."""
    dt = expert_out.dtype
    flat = expert_out.reshape(-1, expert_out.shape[-1])
    flat = torch.cat([flat, torch.zeros_like(flat[:1])], dim=0)
    picked = flat[torch.where(keep, slot,
                              torch.full_like(slot, flat.shape[0] - 1))]
    out = (picked.reshape(t, k, -1).float() * gates[..., None]).sum(dim=1)
    return out.to(dt)


def moe_apply(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss fp32)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gates, ids, aux = _route(cfg, params["router"], xf)
    e, k = cfg.n_experts, cfg.experts_per_token
    # Capacity from static shapes, as the JAX package computes it.
    cap = max(k, int(cfg.capacity_factor * (b * s) * k / e))
    buf, slot, keep = _fill_capacity_buffers(xf, gates, ids, e, cap)
    out = _combine(_expert_ffn(params, buf), slot, keep, gates, b * s, k)
    if cfg.n_shared_experts:
        h = F.silu(dense(xf, params["ws_gate"])) * dense(xf, params["ws_up"])
        out = out + dense(h, params["ws_down"])
    return out.reshape(b, s, d), aux.float()
