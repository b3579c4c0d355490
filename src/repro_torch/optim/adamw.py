"""AdamW by hand, leaf by leaf (port of ``repro.optim.adamw``).

The arithmetic is the reference's (``src/repro/optim/adamw.py:42-73``), in
fp32 whatever the leaves' dtype: the gradient is clipped by
``min(1, grad_clip / max(global_norm, 1e-9))``, weight decay applies to
every leaf (norms included), and the moments are stored in ``state_dtype``.
``torch.optim.AdamW`` and ``clip_grad_norm_`` compute something else
(``clip_grad_norm_`` divides by ``norm + 1e-6``), so neither is used.

A tree here is a mapping from leaf names to tensors (``dict(model.
named_parameters())``); gradients and moments are mappings with the same
names.  The update writes the parameters and moments in place.  The leaves
may be DTensors, cut on one mesh dim or two (the expert leaves: "model"
over the experts, "data" over d_model): the moments are placed as their
parameters, each leaf's sum of squares is reduced over its shards, and
the update is local.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32  # torch.bfloat16 halves it


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig):
    """Zero moments in ``cfg.state_dtype`` beside each parameter (placed
    as it, for a DTensor)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=cfg.state_dtype,
                                memory_format=torch.contiguous_format)

    return {"m": {n: zeros(p) for n, p in params.items()},
            "v": {n: zeros(p) for n, p in params.items()},
            "count": 0}


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state,
                 params: Mapping[str, torch.Tensor], cfg: AdamWConfig,
                 lr_scale=1.0):
    """One AdamW step with global-norm clipping, in place.  Returns
    (params, state) as the reference does; ``state["count"]`` advances."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0) if cfg.grad_clip > 0 else 1.0
    b1, b2 = cfg.b1, cfg.b2
    # The bias corrections in fp32, as the reference computes them.
    n = torch.tensor(float(count), dtype=torch.float32)
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** n
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** n
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32)
    m_all: Dict[str, torch.Tensor] = state["m"]
    v_all: Dict[str, torch.Tensor] = state["v"]
    for name, p in params.items():
        # The reference's expressions, evaluated in place where a result
        # may overwrite an operand (each element takes the same operations
        # in the same order): an fp32 moment is updated where it lies, and
        # at most three leaf-sized temporaries live at once, so a large
        # leaf's update fits beside the state on the card.
        g = grads[name].float() * clip
        m32 = m_all[name].float().mul_(b1).add_((1 - b1) * g)
        v32 = v_all[name].float().mul_(b2).add_((1 - b2) * torch.square(g))
        del g
        step = (m32 / c1).div_(torch.sqrt(v32 / c2).add_(cfg.eps))
        step.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - step.mul_(lr))
        del step
        m_all[name].copy_(m32)
        v_all[name].copy_(v32)
    state["count"] = count
    return params, state
