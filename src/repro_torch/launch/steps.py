"""Step functions run by the drivers (port of ``repro.launch.steps``).

  train_step   — loss + grad + AdamW update (the train_4k cells)
  prefill_step — prompt forward, returns last-position logits + KV cache
  decode_step  — one token against a max_len cache

The training forward takes the plain path (``LM.forward(plain=True)``): the
JAX package differentiates its plain attention and scans and has no
backward kernel, and the port's kernels refuse inputs that require grad.
With ``TrainSettings.compress`` set, the gradients pass through int8
(``_compressed_allreduce``) before the update.  The JAX package's
``input_specs`` / ``make_period_body`` (dry-run tooling) wait for ROADMAP
Queue 1 item 8c.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from ..convert import jax_layout
from ..models import config as mc
from ..models.lm import LM
from ..optim import (AdamWConfig, CompressionConfig, adamw_update,
                     compress_gradients, decompress_gradients, wsd_schedule)
from .sharding import Rules, constrain, use_rules


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
    untouched."""
    params = dict(model.named_parameters())
    with torch.enable_grad():
        loss, _ = model.forward(batch, remat=remat, plain=True)
        grads = torch.autograd.grad(loss, list(params.values()))
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
    stateless form: error feedback is not carried in the step."""
    out: Dict[str, torch.Tensor] = {}
    for key, (stacked, names) in jax_layout(cfg, grads).items():
        g = torch.stack([grads[n] for n in names]) if stacked \
            else grads[names[0]]
        q, s, _ = compress_gradients({key: g}, ccfg)
        del g
        q = {k: constrain(t, ("fsdp",) + (None,) * (t.ndim - 1))
             for k, t in q.items()}
        deq = decompress_gradients(q, s)[key]
        out.update(zip(names, deq.unbind(0)) if stacked
                   else [(names[0], deq)])
    return {n: out[n] for n in grads}


def make_prefill_step(cfg: mc.ModelConfig, max_len: int):
    def prefill_step(model: LM, batch):
        logits, cache, _ = model.prefill(batch, max_len)
        return logits, cache

    return prefill_step


def make_decode_step(cfg: mc.ModelConfig):
    def decode_step(model: LM, batch, cache, pos: int):
        return model.decode_step(batch, cache, pos)

    return decode_step
