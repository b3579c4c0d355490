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
    ``max(k, int(cf·T·k/E))`` from all T tokens.  On DTensors (a model
    of ``LM(..., rules=)``: the "fsdp" profile, whose expert axis is
    empty, or a mesh of one rank) every rank gathers the tokens and the
    router and expert weights whole, as XLA gathers a ZeRO-3 weight, and
    computes the same result (``_single_shard_on_mesh``); each gradient
    returns to its placement as a slice.
  * expert parallel (``_moe_expert_parallel``, the counterpart of
    ``_moe_shardmap``) when ``launch.sharding`` rules are active, the
    "expert" axis has ep > 1 ranks and ep divides E: each rank holds the
    E/ep experts of its "model" coordinate, routes its shard of the tokens,
    and two all-to-alls over the mesh's "model" group carry the capacity
    buffers to the experts' ranks and back.  Each shard sizes its capacity
    from its own token count, so where that count differs from T the
    capacities, hence the drops and the output, differ from the single
    shard's.  This copies the reference on purpose: the port's
    expert-parallel result is held against the JAX package's shard map
    (tests/test_torch_moe_ep.py), not against the single-shard branch.
    The branch takes DTensor parameters placed by the rules, or plain
    per-rank blocks (``convert.expert_block``) with plain tokens, which
    join the mesh as DTensors (``_blocks_expert_parallel``).

The expert-parallel branch runs its sort, ``searchsorted``, ``topk`` and
scatters on local tensors, and its collectives are functional
(``torch.distributed._functional_collectives`` and DTensor
redistributions), so autograd differentiates them and the dry run counts
them.  Its gradients are those of one loss that every rank computes
alike, as ``jax.grad`` of the shard map gives them: a rank's result rows
leave as its shard of a DTensor, so their gradient comes back as that
shard of the whole gradient (the closing gather's backward is a slice);
the aux loss's two sums over the tokens (assignments and probability per
expert) are partial sums of each token shard, all-reduced; where several
ranks route the same tokens (tokens cut over the batch axes only, or not
at all), each one's gradient is divided by their number, as the shard
map's transpose divides the cotangent of an output that is replicated
over an axis; and the gradients of the tokens, the router and the expert
blocks are declared ``Partial`` over the mesh dims on which the ranks'
contributions differ, so that each is summed once and returned to its
placement (a reduce-scatter over "data" for the expert leaves).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from .. import obs
from ..launch.sharding import (Rules, current_rules, from_local, frozen,
                               is_dtensor, shard_offsets)
from .config import ModelConfig
from .layers import DOWN_W, UP_W, PSpec, dense

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


def _gate(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """x: (T, D) -> probs (T, E) fp32, gates (T, k) fp32, expert ids
    (T, k), and the assignments each expert took, (E,) fp32."""
    logits = dense(x, router_w).float()                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    load = torch.zeros((cfg.n_experts,), dtype=torch.float32,
                       device=x.device)
    load = load.index_add_(0, ids.reshape(-1),
                           torch.ones(ids.numel(), device=x.device))
    return probs, gates, ids, load


def _aux(e: int, load: torch.Tensor, mean_probs: torch.Tensor):
    """Switch-style load-balance aux: E * Σ_e mean_load_e * mean_prob_e."""
    load = load / load.sum().clamp_min(1.0)
    return e * torch.sum(load * mean_probs)


def _route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """x: (T, D) -> gates (T, k) fp32, expert ids (T, k), aux loss scalar."""
    probs, gates, ids, load = _gate(cfg, router_w, x)
    return gates, ids, _aux(cfg.n_experts, load, probs.mean(0))


def _fill_capacity_buffers(x, gates, ids, n_experts: int, capacity: int):
    """Scatter (T,D) tokens into (E, C, D) buffers, dropping overflow.

    Returns the buffers, plus (slot, keep) to invert the scatter at
    combine.  A dropped assignment's slot is the overflow row E·C, as in
    the JAX package.  While profiling, counts the assignments (T·k), the
    slots (E·C) and the assignments kept (``obs``).
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
    obs.count("moe.assignments", t * k)
    obs.count("moe.slots", n_experts * capacity)
    obs.count("moe.kept", keep)
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
              x: torch.Tensor, layer: int = -1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss fp32); DTensors for a DTensor x.
    Runs in the span ``repro_torch.moe`` (``layer`` its index), whose
    children are ``moe.route``, ``moe.dispatch``, ``moe.experts``,
    ``moe.combine`` and ``moe.shared``."""
    with obs.span("moe", layer=layer):
        return _moe(cfg, params, x)


def _moe(cfg: ModelConfig, params, x):
    rules = current_rules()
    e = cfg.n_experts
    ep = rules.axis_size("expert") if rules else 1
    expert_parallel = bool(rules) and ep > 1 and e % ep == 0
    if expert_parallel:
        _check_apart(rules)
    if is_dtensor(x):
        if rules is None:
            raise RuntimeError("a DTensor MoE runs under its rules "
                               "(launch.sharding.use_rules)")
        out, aux = (_moe_expert_parallel(cfg, params, x, rules, ep)
                    if expert_parallel else
                    _single_shard_on_mesh(cfg, params, x))
    elif expert_parallel:
        out, aux = _blocks_expert_parallel(cfg, params, x, rules, ep)
    else:
        b, s, d = x.shape
        out, aux = _single_shard(cfg, params, x.reshape(b * s, d))
        out = out.reshape(b, s, d)
    if cfg.n_shared_experts:
        with obs.span("moe.shared"):
            h = F.silu(dense(x, params["ws_gate"], UP_W)) * \
                dense(x, params["ws_up"], UP_W)
            out = out + dense(h, params["ws_down"], DOWN_W)
    return out, aux


def _single_shard(cfg: ModelConfig, params, xf):
    """The single-shard branch on local tensors: xf (T, D) -> (out (T, D),
    aux fp32).  The capacity from static shapes, as the JAX package
    computes it."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token
    with obs.span("moe.route"):
        gates, ids, aux = _route(cfg, params["router"], xf)
    cap = max(k, int(cfg.capacity_factor * t * k / e))
    with obs.span("moe.dispatch"):
        buf, slot, keep = _fill_capacity_buffers(xf, gates, ids, e, cap)
    with obs.span("moe.experts"):
        y = _expert_ffn(params, buf)
    with obs.span("moe.combine"):
        out = _combine(y, slot, keep, gates, t, k)
    return out, aux.float()


def _local(t, placements, grads):
    """This rank's tensor of the DTensor ``t`` redistributed to
    ``placements``, its gradient declared placed as ``grads``."""
    return frozen(t).redistribute(t.device_mesh, placements).to_local(
        grad_placements=grads)


def _single_shard_on_mesh(cfg: ModelConfig, params, x):
    """The single-shard branch on DTensors: tokens and weights gathered
    whole on every rank, which all compute the same result; its gradients
    (whole on every rank alike, so declared ``Replicate``) return to their
    placements as slices, and the result leaves placed as ``x``."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    whole = [Replicate()] * mesh.ndim
    b, s, d = x.shape
    w = {n: _local(params[n], whole, whole)
         for n in ("router",) + EXPERT_LEAVES}
    out, aux = _single_shard(cfg, w, _local(x, whole, whole).reshape(
        b * s, d))
    out = from_local(out.reshape(b, s, d), mesh, whole, x.shape)
    return (out.redistribute(mesh, _reduced(x.placements)),
            from_local(aux, mesh, whole, ()))


def _reduced(placements):
    """``placements`` with each ``Partial`` made ``Replicate``: where a
    result leaves placed as its input, which may be a pending sum."""
    from torch.distributed.tensor import Replicate
    return [Replicate() if p.is_partial() else p for p in placements]


def _check_apart(rules: Rules):
    """Rules that put "batch" and "expert" on a common mesh dim are
    refused: the token shard would then name that dim twice."""
    shared = set(rules.logical["batch"]) & set(rules.logical["expert"])
    if shared:
        raise ValueError(
            f"the rules put 'batch' {rules.logical['batch']} and 'expert' "
            f"{rules.logical['expert']} on the mesh dims {sorted(shared)}: "
            f"the expert-parallel MoE needs them apart")


def token_split(cfg: ModelConfig, rules: Rules, t_total: int, ep: int):
    """(token axes, tokens a shard, capacity) of the expert-parallel
    branch, as the reference splits the tokens: over the batch and expert
    axes when dp·ep divides T, over the batch axes when dp does, else not
    at all (each shard then routes the same tokens)."""
    batch_axes = rules.logical["batch"]
    dp = rules.axis_size("batch")
    if t_total % (dp * ep) == 0:
        tok_axes: tuple = tuple(batch_axes) + tuple(rules.logical["expert"])
    elif t_total % dp == 0:
        tok_axes = tuple(batch_axes)
    else:
        tok_axes = ()
    t_local = max(1, t_total // max(
        1, (dp * ep) if len(tok_axes) > len(batch_axes) else
        (dp if tok_axes else 1)))
    k = cfg.experts_per_token
    return tok_axes, t_local, max(k, int(cfg.capacity_factor * t_local * k
                                         / cfg.n_experts))


def _blocks_expert_parallel(cfg: ModelConfig, params, x, rules: Rules,
                            ep: int):
    """The expert-parallel branch on plain tensors: every rank holds all
    T tokens, the router whole and its block of E/ep experts
    (``convert.expert_block``).  They join ``rules.mesh`` as DTensors (the
    tokens and router replicated, the blocks cut on "model"), and the
    routed rows come back whole on every rank, as do the gradients of the
    tokens and the router; each block's gradient is its own experts'."""
    from torch.distributed.tensor import Replicate, Shard
    e = cfg.n_experts
    mesh = rules.mesh
    whole = [Replicate()] * mesh.ndim
    model = mesh.mesh_dim_names.index(rules.logical["expert"][0])
    blocks = [Shard(0) if i == model else Replicate()
              for i in range(mesh.ndim)]
    wrapped = {"router": from_local(params["router"], mesh, whole,
                                    params["router"].shape)}
    for n in EXPERT_LEAVES:
        w = params[n]
        wrapped[n] = from_local(w, mesh, blocks, (e,) + tuple(w.shape[1:]))
    out, aux = _moe_expert_parallel(cfg, wrapped,
                                    from_local(x, mesh, whole, x.shape),
                                    rules, ep)
    return out.to_local(), aux.to_local()


def _moe_expert_parallel(cfg: ModelConfig, params, x, rules: Rules,
                         ep: int):
    """The JAX package's ``_moe_shardmap`` on DTensors: x (B, S, D) ->
    (routed out placed as x, aux a replicated scalar).

    Each rank takes the rows of its token shard (``token_split``; shard
    index row-major over the token axes, the batch axes first) from its
    block of x: x's own rows where x is cut evenly over every batch axis,
    else x gathered whole (under "sp" the sequence is gathered first).  It
    routes them with the router gathered whole, fills (E, C, D) capacity
    buffers with C from the shard's token count; the first all-to-all over
    the "model" group sends expert block j to model rank j, the blocks
    received stacked along the capacity axis in source-rank order,
    (E/ep, ep·C, D); the local experts run (their leaves gathered over
    the mesh's other dims, "fsdp" under the default profile); the second
    all-to-all is the inverse (``dispatch``).  The combined rows leave as
    this rank's shard, over the token axes, of the (T, D) result, which is
    gathered to x's block and placed as x (a pending sum in x's placements
    as ``Replicate``).  See the module docstring for the gradients."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    dims = range(mesh.ndim)
    every = [Replicate()] * mesh.ndim
    e, k = cfg.n_experts, cfg.experts_per_token
    b, s, d = x.shape
    t_total = b * s
    tok_axes, t_local, cap = token_split(cfg, rules, t_total, ep)
    tok = [names.index(a) for a in tok_axes]
    model = names.index(rules.logical["expert"][0])
    # The ranks that route the same tokens.
    replicas = math.prod(mesh.size(i) for i in dims if i not in tok)

    batch = [names.index(a) for a in rules.logical["batch"]]
    if not (all(x.placements[i] == Shard(0) for i in batch)
            and b % math.prod(mesh.size(i) for i in batch) == 0):
        batch = []
    block = [Shard(0) if i in batch else Replicate() for i in dims]
    xb = x.redistribute(mesh, block)
    xl = xb.to_local(grad_placements=[
        Shard(0) if i in batch else Partial() for i in dims]).reshape(-1, d)
    shard = 0
    for a in tok_axes:
        shard = shard * rules.sizes[a] + mesh.get_local_rank(a)
    lo = shard * t_local - shard_offsets(xb)[0] * s
    if not 0 <= lo <= xl.shape[0] - t_local:
        raise RuntimeError(f"token shard {shard} is not in this rank's "
                           f"block of {xl.shape[0]} rows")
    xr = xl[lo:lo + t_local]

    with obs.span("moe.route"):
        probs, gates, ids, load = _gate(
            cfg, _local(params["router"], every, [Partial()] * mesh.ndim),
            xr)
        sums = from_local(torch.cat([probs.sum(0), load]), mesh,
                          [Partial() if i in tok else Replicate()
                           for i in dims],
                          (2 * e,)).redistribute(mesh, every).to_local()
        aux = _aux(e, sums[e:], sums[:e] / t_total)

    w = {n: _local(params[n], [Shard(0) if i == model else Replicate()
                               for i in dims],
                   [Shard(0) if i == model else Partial() for i in dims])
         for n in EXPERT_LEAVES}
    if w["w_gate"].shape[0] != e // ep:
        raise ValueError(f"this rank holds {w['w_gate'].shape[0]} experts, "
                         f"not E/ep = {e // ep}: cut them with "
                         f"convert.expert_block")
    with obs.span("moe.dispatch"):
        buf, slot, keep = _fill_capacity_buffers(xr, gates, ids, e, cap)
    y = dispatch(w, buf, (mesh, model), ep)
    with obs.span("moe.combine"):
        out = _combine(y, slot, keep, gates, t_local, k)
    out, aux = (_grad_scaled(t, 1.0 / replicas) for t in (out, aux))
    out = from_local(out, mesh, [Shard(0) if i in tok else Replicate()
                                 for i in dims], (t_total, d))
    out = out.redistribute(mesh, block).to_local()
    out = from_local(out.reshape(-1, s, d), mesh, block, x.shape)
    return (out.redistribute(mesh, _reduced(x.placements)),
            from_local(aux, mesh, every, ()))


def dispatch(w: Mapping[str, torch.Tensor], buf: torch.Tensor, group,
             ep: int) -> torch.Tensor:
    """buf (E, C, D), this rank's capacity buffers -> (E, C, D), each
    expert's output for them: an all-to-all over ``group`` (ep ranks, a
    functional collective that autograd differentiates) to the ranks that
    hold the experts, ``w``'s E/ep experts on the ep·C rows received, and
    the inverse all-to-all: in the spans ``moe.dispatch``,
    ``moe.experts`` and ``moe.combine``."""
    from torch.distributed import _functional_collectives as funcol
    e, cap, d = buf.shape
    el = e // ep
    with obs.span("moe.dispatch"):
        recv = funcol.all_to_all_single_autograd(buf, None, None, group)
    with obs.span("moe.experts"):
        out = _expert_ffn(w, recv.reshape(ep, el, cap, d).transpose(0, 1)
                          .reshape(el, ep * cap, d))
    send = out.reshape(el, ep, cap, d).transpose(0, 1).reshape(e, cap, d)
    with obs.span("moe.combine"):
        return funcol.all_to_all_single_autograd(send, None, None, group)


def _grad_scaled(t: torch.Tensor, scale: float) -> torch.Tensor:
    """``t``, whose gradient is multiplied by ``scale`` on its way back."""
    if scale != 1.0 and t.requires_grad:
        t.register_hook(lambda g: g * scale)
    return t
