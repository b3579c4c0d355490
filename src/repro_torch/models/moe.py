"""Mixture-of-Experts (port of ``repro.models.moe``).

The JAX package's sort-based dispatch, copied: the router's top-k
assignments are ranked within their expert by a stable sort, scattered into
per-expert capacity buffers (assignments past an expert's capacity are
dropped, and the drops are part of the function), run through every
expert's SwiGLU as three batched products, and combined back with the fp32
gates.  The result is cast back to the activations' dtype.  Nothing here
syncs the host: the kept rows are selected by index arithmetic, never by a
boolean mask.

Two branches, chosen as the JAX package chooses them:
  * single shard (no rules active, or the experts do not divide over the
    "expert" axis): every expert on this device, the capacity
    ``max(k, int(cf·T·k/E))`` from all T tokens;
  * expert parallel (``_moe_expert_parallel``, the counterpart of
    ``_moe_shardmap``) when ``launch.sharding`` rules are active, the
    "expert" axis has ep > 1 ranks and ep divides E: each rank of the
    ``torch.distributed`` mesh holds its E/ep experts
    (``convert.expert_block``), routes its shard of the tokens, and two
    ``all_to_all_single`` over the mesh's "model" group carry the capacity
    buffers to the experts' ranks and back.  Each shard sizes its capacity
    from its own token count, so where that count differs from T the
    capacities, hence the drops and the output, differ from the single
    shard's.  This copies the reference on purpose: the port's
    expert-parallel result is held against the JAX package's shard map
    (tests/test_torch_moe_ep.py), not against the single-shard branch.
    The all-to-alls are not differentiated: the branch refuses to run with
    grad (training with expert parallelism is not ported).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..launch.sharding import Rules, current_rules
from .config import ModelConfig
from .layers import PSpec, dense

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")   # sharded over "expert"


def moe_specs(cfg: ModelConfig) -> Dict[str, PSpec]:
    d, e = cfg.d_model, cfg.n_experts
    f = cfg.expert_d_ff or cfg.d_ff
    specs = {
        "router": PSpec((d, e), (None, "model"), scale=1.0 / math.sqrt(d)),
        "w_gate": PSpec((e, d, f), ("expert", "fsdp", None)),
        "w_up": PSpec((e, d, f), ("expert", "fsdp", None)),
        "w_down": PSpec((e, f, d), ("expert", None, "fsdp")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        specs.update({
            "ws_gate": PSpec((d, fs), ("fsdp", "model")),
            "ws_up": PSpec((d, fs), ("fsdp", "model")),
            "ws_down": PSpec((fs, d), ("model", "fsdp")),
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
    rules = current_rules()
    xf = x.reshape(b * s, d)
    e, k = cfg.n_experts, cfg.experts_per_token
    ep = rules.axis_size("expert") if rules else 1
    expert_parallel = bool(rules) and ep > 1 and e % ep == 0
    if expert_parallel:
        _refuse_grad(x, params)
    gates, ids, aux = _route(cfg, params["router"], xf)
    if expert_parallel:
        out = _moe_expert_parallel(cfg, params, xf, gates, ids, rules, ep)
    else:
        # Capacity from static shapes, as the JAX package computes it.
        cap = max(k, int(cfg.capacity_factor * (b * s) * k / e))
        buf, slot, keep = _fill_capacity_buffers(xf, gates, ids, e, cap)
        out = _combine(_expert_ffn(params, buf), slot, keep, gates, b * s,
                       k)
    if cfg.n_shared_experts:
        h = F.silu(dense(xf, params["ws_gate"])) * dense(xf, params["ws_up"])
        out = out + dense(h, params["ws_down"])
    return out.reshape(b, s, d), aux.float()


def _refuse_grad(x: torch.Tensor, params: Mapping[str, torch.Tensor]):
    if torch.is_grad_enabled() and (x.requires_grad or any(
            params[n].requires_grad for n in ("router",) + EXPERT_LEAVES)):
        raise ValueError(
            "the expert-parallel MoE has no backward (its all-to-alls are "
            "not differentiated): call it under torch.no_grad() or "
            "torch.inference_mode()")


def _moe_expert_parallel(cfg: ModelConfig, params, xf, gates, ids,
                         rules: Rules, ep: int) -> torch.Tensor:
    """The JAX package's ``_moe_shardmap`` on ``torch.distributed``.

    Every rank of ``rules.mesh`` is called with the whole batch of T tokens
    and its routing, as the SPMD program sees them, and holds the E/ep
    experts of its "model" coordinate m (rows m·E/ep onward, as
    ``P("model")`` places them).  The tokens are split as the reference
    splits them: over the batch and expert axes when dp·ep divides T, over
    the batch axes when dp does, else not at all (each shard then routes
    the same tokens).  Each rank fills (E, C, D) capacity buffers from its
    shard, with C from the shard's token count; the first all-to-all sends
    expert block j to model rank j, the blocks received stacked along the
    capacity axis in source-rank order, (E/ep, ep·C, D); the local experts
    run; the second all-to-all is the inverse.  The combined rows are
    all-gathered over the token axes, so every rank returns all T rows.

    Rules that put "batch" and "expert" on a common mesh dim are refused:
    the token shard would then name that dim twice."""
    import torch.distributed as dist
    shared = set(rules.logical["batch"]) & set(rules.logical["expert"])
    if shared:
        raise ValueError(
            f"the rules put 'batch' {rules.logical['batch']} and 'expert' "
            f"{rules.logical['expert']} on the mesh dims {sorted(shared)}: "
            f"the expert-parallel MoE needs them apart")
    e, k = cfg.n_experts, cfg.experts_per_token
    el = e // ep
    if params["w_gate"].shape[0] != el:
        raise ValueError(f"this rank holds {params['w_gate'].shape[0]} "
                         f"experts, not E/ep = {el}: cut them with "
                         f"convert.expert_block")
    mesh = rules.mesh
    batch_axes = rules.logical["batch"]
    model_axes = rules.logical["expert"]
    t_total, d = xf.shape
    dp = rules.axis_size("batch")
    if t_total % (dp * ep) == 0:
        tok_axes: tuple = tuple(batch_axes) + tuple(model_axes)
    elif t_total % dp == 0:
        tok_axes = tuple(batch_axes)
    else:
        tok_axes = ()
    t_local = max(1, t_total // max(
        1, (dp * ep) if len(tok_axes) > len(batch_axes) else
        (dp if tok_axes else 1)))
    cap = max(k, int(cfg.capacity_factor * t_local * k / e))
    # This rank's token shard: row-major over the token axes.
    shard = 0
    for a in tok_axes:
        shard = shard * rules.sizes[a] + mesh.get_local_rank(a)
    rows = slice(shard * t_local, (shard + 1) * t_local)
    gl = gates[rows]
    buf, slot, keep = _fill_capacity_buffers(xf[rows], gl, ids[rows], e, cap)

    group = mesh.get_group(model_axes[0])
    recv = torch.empty_like(buf)
    dist.all_to_all_single(recv, buf, group=group)
    out = _expert_ffn(params, recv.view(ep, el, cap, d).transpose(0, 1)
                      .reshape(el, ep * cap, d))
    send = out.view(el, ep, cap, d).transpose(0, 1).contiguous()
    back = torch.empty_like(send)
    dist.all_to_all_single(back, send, group=group)
    out = _combine(back.view(e, cap, d), slot, keep, gl, t_local, k)
    # Gather the shards, the fastest token axis first.
    for a in reversed(tok_axes):
        parts = [torch.empty_like(out) for _ in range(rules.sizes[a])]
        dist.all_gather(parts, out, group=mesh.get_group(a))
        out = torch.cat(parts)
    return out
