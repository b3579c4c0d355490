"""Step functions run by the drivers (port of ``repro.launch.steps``).

  train_step   — loss + grad + AdamW update (the train_4k cells)
  prefill_step — prompt forward, returns last-position logits + KV cache
  decode_step  — one token against a max_len cache

The training forward takes the plain path (``LM.forward(plain=True)``): the
JAX package differentiates its plain attention and scans and has no
backward kernel, and the port's kernels refuse inputs that require grad.
With ``TrainSettings.compress`` set, the gradients pass through int8
(``_compressed_allreduce``) before the update.

Given ``rules``, each step runs under them (``use_rules``) on a model of
DTensor parameters placed by them (``LM(..., rules=)``,
``convert.params_from_numpy(..., rules=)``): the port's counterpart of the
JAX package's steps under ``use_rules`` and jit, for every arch (the
expert leaves are cut on two mesh dims, "model" over the experts and
"data" over d_model, and the expert-parallel MoE's all-to-alls are
differentiated; the mamba, mLSTM and sLSTM recurrences run on each rank's
local shards).  The batch may hold
plain tensors that every rank has whole; the model places them.  The
gradients come back placed as their parameters, and AdamW updates each
rank's shards.

Plus per-shape ``input_specs``: everything a step takes, as ``meta``
tensors (DTensors placed by the rules when rules are given) that allocate
nothing, in the port's own layout: parameters and AdamW moments keyed by
``LM.named_parameters`` names, the cache in ``init_cache``'s layout, and
the step index and decode position as the Python ints the step functions
take.  ``make_period_body`` is one period of the layer stack as its own
function; ``launch.dryrun`` reads both.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..convert import jax_layout
from ..models import config as mc
from ..models.blocks import layer_specs, mixer
from ..models.layers import param_structs
from ..models.layers import struct as _struct
from ..models.lm import (LM, cache_specs, init_cache, named_param_specs,
                         run_layers)
from ..optim import (AdamWConfig, CompressionConfig, adamw_update,
                     compress_gradients, decompress_gradients, wsd_schedule)
from .sharding import Rules, constrain, is_dtensor, use_rules


@dataclass(frozen=True)
class TrainSettings:
    remat: str = "dots"
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    # int8 gradient compression around the DP all-reduce (beyond-paper).
    compress: Optional[CompressionConfig] = None
    schedule: str = "wsd"
    warmup: int = 100
    stable: int = 10_000
    decay: int = 1_000


def loss_and_grads(model: LM, batch: Dict[str, torch.Tensor],
                   remat: str = "none"):
    """(loss, {parameter name: gradient}) of the training forward, on the
    plain path; the loss is detached and the parameters' ``.grad`` stay
    untouched.  A DTensor parameter's gradient is placed as the parameter
    (a partial sum over the ranks that shared it is reduced)."""
    params = dict(model.named_parameters())
    with torch.enable_grad():
        loss, _ = model.forward(batch, remat=remat, plain=True)
        grads = torch.autograd.grad(loss, list(params.values()))
    grads = [g.redistribute(p.device_mesh, p.placements) if is_dtensor(g)
             else g for p, g in zip(params.values(), grads)]
    return loss.detach(), dict(zip(params, grads))


def make_train_step(cfg: mc.ModelConfig, settings: TrainSettings,
                    rules: Optional[Rules] = None):
    def lr_scale(step):
        return wsd_schedule(step, warmup=settings.warmup,
                            stable=settings.stable, decay=settings.decay)

    def train_step(model: LM, opt_state, batch, step: int):
        """One step in place: returns (model, opt_state, loss)."""
        with use_rules(rules):
            loss, grads = loss_and_grads(model, batch, settings.remat)
            if settings.compress is not None:
                grads = _compressed_allreduce(cfg, grads, settings.compress,
                                              rules)
            adamw_update(grads, opt_state, dict(model.named_parameters()),
                         settings.opt, lr_scale(step))
        return model, opt_state, loss

    return train_step


def _compressed_allreduce(cfg: mc.ModelConfig,
                          grads: Dict[str, torch.Tensor],
                          ccfg: CompressionConfig, rules: Optional[Rules]):
    """Quantize -> (the data-parallel reduction) -> dequantize.

    The scale is per leaf of the JAX package's tree, as the reference
    quantizes: a leaf stacked over the periods of ``cfg.pattern`` holds the
    same parameter of several layers (``convert.jax_layout``) under one
    scale, so those gradients are stacked, one leaf at a time, before they
    are quantized, and the dequantized rows are handed back per layer.
    Each int8 leaf passes through ``constrain`` to ("fsdp", None, ...), so
    a gradient held as a DTensor moves as int8 between the ranks; a plain
    tensor, or no active rules, passes unchanged.  This is the reference's
    stateless form: error feedback is not carried in the step.

    On DTensors the scale is the whole leaf's: the max is reduced over the
    mesh.  The constraint may cut a stacked leaf on its period dim, so the
    dequantized leaf is redistributed back to the placements ``torch.stack``
    gave the gradients (whole on the period dim) before it is split per
    layer, and each row is then placed as its parameter's gradient was, so
    AdamW's in-place updates meet shards of the parameter's layout.  Both
    moves, and the constraint, are plain ``redistribute`` calls, which
    NCCL and gloo take for int8 and fp32 alike (gloo has no all-to-all:
    there DTensor moves a shard from one tensor dim to another by an
    all-gather and a local chunk)."""
    out: Dict[str, torch.Tensor] = {}
    for key, (stacked, names) in jax_layout(cfg, grads).items():
        g = torch.stack([grads[n] for n in names]) if stacked \
            else grads[names[0]]
        q, s, _ = compress_gradients({key: g}, ccfg)
        stack_layout = _layout(g)
        del g
        q = {k: constrain(t, ("fsdp",) + (None,) * (t.ndim - 1))
             for k, t in q.items()}
        deq = _placed(decompress_gradients(q, s)[key], stack_layout)
        rows = deq.unbind(0) if stacked else [deq]
        out.update((n, _placed(r, _layout(grads[n])))
                   for n, r in zip(names, rows))
    return {n: out[n] for n in grads}


def _layout(t: torch.Tensor):
    """(mesh, placements) of a DTensor; None for a plain tensor."""
    return (t.device_mesh, tuple(t.placements)) if is_dtensor(t) else None


def _placed(t: torch.Tensor, layout) -> torch.Tensor:
    """``t`` redistributed to ``layout`` (``_layout`` of another tensor);
    ``t`` itself when ``layout`` is None or ``t`` is placed so already."""
    if layout is None or tuple(t.placements) == layout[1]:
        return t
    return t.redistribute(*layout)


def make_prefill_step(cfg: mc.ModelConfig, max_len: int,
                      rules: Optional[Rules] = None):
    def prefill_step(model: LM, batch):
        with use_rules(rules):
            logits, cache, _ = model.prefill(batch, max_len)
        return logits, cache

    return prefill_step


def make_decode_step(cfg: mc.ModelConfig, rules: Optional[Rules] = None):
    def decode_step(model: LM, batch, cache, pos: int):
        with use_rules(rules):
            return model.decode_step(batch, cache, pos)

    return decode_step


# ---------------------------------------------------------------------------
# Input specs (meta-tensor stand-ins; zero allocation)
# ---------------------------------------------------------------------------
def batch_specs(cfg: mc.ModelConfig, B: int, S: int, rules, *,
                with_labels: bool) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if cfg.input_mode == "tokens":
        out["tokens"] = _struct((B, S), torch.int32, rules, ("batch", None))
    elif cfg.input_mode == "embeds":
        out["frame_embeds"] = _struct((B, S, cfg.d_model), torch.bfloat16,
                                      rules, ("batch", None, None))
    else:  # mixed VLM
        n_patch = max(1, int(S * cfg.patch_frac)) if S > 1 else 0
        n_text = S - n_patch
        out["patch_embeds"] = _struct((B, n_patch, cfg.d_model),
                                      torch.bfloat16, rules,
                                      ("batch", None, None))
        out["tokens"] = _struct((B, n_text), torch.int32, rules,
                                ("batch", None))
    if with_labels:
        out["labels"] = _struct((B, S), torch.int32, rules, ("batch", None))
    return out


def model_structs(cfg: mc.ModelConfig, rules, dtype=torch.bfloat16):
    """{parameter name: struct}, as ``dict(LM.named_parameters())``."""
    return param_structs(named_param_specs(cfg), rules, dtype)


def opt_structs(cfg: mc.ModelConfig, rules, opt_cfg: AdamWConfig):
    """``adamw_init``'s state: m and v in ``opt_cfg.state_dtype``, placed
    as their parameters, and the count (a Python int in the port)."""
    def moments():
        return {n: _struct(s.shape, opt_cfg.state_dtype, rules, s.axes)
                for n, s in named_param_specs(cfg).items()}

    return {"m": moments(), "v": moments(), "count": 0}


def cache_structs(cfg: mc.ModelConfig, B: int, max_len: int, rules,
                  dtype=torch.bfloat16):
    return cache_structs_from(cache_specs(cfg, B, max_len), rules, dtype)


def cache_structs_from(spec_tree, rules, dtype=torch.bfloat16):
    """A cache spec tree as structs: a leaf that pins its dtype (the
    recurrent states' fp32) keeps it, the others take ``dtype``."""
    return param_structs(spec_tree, rules, dtype)


def input_specs(cfg: mc.ModelConfig, shape: mc.ShapeConfig,
                rules: Optional[Rules], settings: TrainSettings):
    """Everything the step for this shape-kind takes, as structs.  The
    step index is 0; a decode step runs at position ``seq_len - 1``, the
    last row of its ``seq_len`` cache (the reference traces both as int32
    scalars)."""
    B, S = shape.global_batch, shape.seq_len
    params = model_structs(cfg, rules)
    if shape.kind == "train":
        return dict(
            params=params,
            opt_state=opt_structs(cfg, rules, settings.opt),
            batch=batch_specs(cfg, B, S, rules, with_labels=True),
            step=0,
        )
    if shape.kind == "prefill":
        return dict(params=params,
                    batch=batch_specs(cfg, B, S, rules, with_labels=False))
    # decode: one new token against a seq_len cache
    one = batch_specs(cfg, B, 1, rules, with_labels=False)
    return dict(params=params, batch=one,
                cache=cache_structs(cfg, B, S, rules), pos=S - 1)


# ---------------------------------------------------------------------------
# Period body
# ---------------------------------------------------------------------------
def make_period_body(cfg: mc.ModelConfig, shape: mc.ShapeConfig,
                     rules: Optional[Rules], settings: TrainSettings):
    """One period of the layer stack (the layers of ``cfg.pattern``) as
    its own function, on the plain path, with its arguments as structs:
    (fn, example_args), or None when there is no stack of several periods.

    The reference compiles it because XLA counts a while-loop body once,
    and scales the body's cost by the trip count.  The port's meta pass
    runs every layer, so ``launch.dryrun`` needs no such correction: the
    body is the check that it needs none (its products times
    ``n_periods`` are the layers' share of the whole pass).  The body is
    ``lm.run_layers`` over a one-period slice of ``cfg``.  The train body
    returns ``sum(h.float()) + aux`` and its gradients with respect to the
    period's parameters and x, each layer recomputed under
    ``settings.remat`` (the port's unit of remat is the layer; the
    reference's is the period).  The inference body runs prefill (into a
    zeroed cache of the period, as ``LM.prefill`` does) or decode at
    position 0 through one period."""
    if cfg.n_periods <= 1:
        return None
    one = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    period = range(len(cfg.pattern))
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    lp = param_structs({f"p{p}": layer_specs(cfg, p) for p in period},
                       rules, torch.bfloat16)
    x = _struct((B, S, cfg.d_model), torch.bfloat16, rules,
                ("batch", None, None))
    if cfg.mrope:
        pos = _struct((3, B, S), torch.int32, rules, (None, "batch", None))
    else:
        pos = _struct((B, S), torch.int32, rules, ("batch", None))
    cache = None
    if shape.kind == "decode":
        cache = cache_structs_from(
            {f"p{p}": mixer(cfg.pattern[p])[2](cfg, B, shape.seq_len)
             for p in period}, rules)

    def body_train(layer_params, x, positions):
        with use_rules(rules), torch.enable_grad():
            leaves, tree = tree_flatten(layer_params)
            leaves = [t.detach().requires_grad_() for t in leaves]
            lp_ = tree_unflatten(leaves, tree)
            x_ = x.detach().requires_grad_()
            h, aux = run_layers(one, [lp_[f"p{p}"] for p in period], x_,
                                mode="train", positions=positions,
                                remat=settings.remat, plain=True)
            val = torch.sum(h.float()) + aux
            grads = torch.autograd.grad(val, leaves + [x_],
                                        allow_unused=True)
        return val.detach(), (tree_unflatten(list(grads[:-1]), tree),
                              grads[-1])

    def body_infer(layer_params, x, positions, cache_in):
        mode = "decode" if shape.kind == "decode" else "prefill"
        with use_rules(rules), torch.inference_mode():
            if cache_in is None:
                stacked = init_cache(one, B, shape.seq_len, dtype=x.dtype,
                                     device=x.device)
            else:
                stacked = {"layers": {k: {n: t.unsqueeze(0)
                                          for n, t in c.items()}
                                      for k, c in cache_in.items()}}
            h, _ = run_layers(one, [layer_params[f"p{p}"] for p in period],
                              x, mode=mode, positions=positions,
                              cache=stacked, max_len=shape.seq_len,
                              plain=True)
        return h, {k: {n: t[0] for n, t in c.items()}
                   for k, c in stacked["layers"].items()}

    if shape.kind == "train":
        return body_train, (lp, x, pos)
    return body_infer, (lp, x, pos, cache)
