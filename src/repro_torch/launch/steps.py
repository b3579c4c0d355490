"""Step functions run by the drivers (port of ``repro.launch.steps``).

  train_step   — loss + grad + AdamW update (the train_4k cells)
  prefill_step — prompt forward, returns last-position logits + KV cache
  decode_step  — one token against a max_len cache

The training forward takes the plain path (``LM.forward(plain=True)``): the
JAX package differentiates its plain attention and scans and has no
backward kernel, and the port's kernels refuse inputs that require grad.
The JAX package's ``input_specs`` / ``make_period_body`` (dry-run tooling)
and the int8 gradient compression wait for ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from ..models import config as mc
from ..models.blocks import not_ported
from ..models.lm import LM
from ..optim import AdamWConfig, adamw_update, wsd_schedule


@dataclass(frozen=True)
class TrainSettings:
    remat: str = "dots"
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    # int8 gradient compression around the DP all-reduce: not ported.
    compress: Optional[object] = None
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


def make_train_step(cfg: mc.ModelConfig, settings: TrainSettings):
    if settings.compress is not None:
        raise not_ported("compress")

    def lr_scale(step):
        return wsd_schedule(step, warmup=settings.warmup,
                            stable=settings.stable, decay=settings.decay)

    def train_step(model: LM, opt_state, batch, step: int):
        """One step in place: returns (model, opt_state, loss)."""
        loss, grads = loss_and_grads(model, batch, settings.remat)
        adamw_update(grads, opt_state, dict(model.named_parameters()),
                     settings.opt, lr_scale(step))
        return model, opt_state, loss

    return train_step


def make_prefill_step(cfg: mc.ModelConfig, max_len: int):
    def prefill_step(model: LM, batch):
        logits, cache, _ = model.prefill(batch, max_len)
        return logits, cache

    return prefill_step


def make_decode_step(cfg: mc.ModelConfig):
    def decode_step(model: LM, batch, cache, pos: int):
        return model.decode_step(batch, cache, pos)

    return decode_step
