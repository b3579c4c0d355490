"""The reference decoder: embedding, then per layer a mixer and an
optional feed-forward each added to the residual stream (times the
model's residual scale), then the head.  The layer kinds are the files of
this folder, found by name; a model file (``perfbench/models``) gives the
plan.  Each layer's weights are drawn again from the seed when the pass
reaches it and freed after it, so the pass holds one layer at a time."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from perfbench import registry
from perfbench.reference.precision import Precision
from perfbench.weights import Param, draw


@dataclass
class Plan:
    """A model as the reference runs it: ``layers`` holds each layer's
    (mixer kind, feed-forward kind or None), ``dims`` the sizes and scales
    the layer files read."""
    layers: List[Tuple[str, Optional[str]]]
    dims: Dict[str, object]
    dtype: torch.dtype = torch.bfloat16     # the dtype the weights are served in


@dataclass
class Ctx:
    prec: Precision
    dims: Dict[str, object]
    prefix: int = 0                 # prompt positions; the rest are decoded


def kind(name: str):
    return registry.module("reference", name)


def schema(plan: Plan) -> Dict[str, Param]:
    """{leaf name as the port's model holds it: its draw}."""
    out = dict(kind("embed").params(plan.dims))
    out.update(kind("head").params(plan.dims))
    for i, (mixer, ffn) in enumerate(plan.layers):
        for part, k in (("mixer", mixer), ("ffn", ffn)):
            if k is not None:
                out.update({f"layers.{i}.{part}.{n}": p
                            for n, p in kind(k).params(plan.dims).items()})
    return out


def _weights(names, plan, seed, device, strip=""):
    sch = schema(plan)
    return {n[len(strip):]: draw(sch[n], seed, n, plan.dtype, device).float()
            for n in names}


@torch.no_grad()
def logits(plan: Plan, seed: int, tokens: torch.Tensor, prefix: int,
           precision: str = "float32") -> torch.Tensor:
    """tokens (B, L): each request's prompt (``prefix`` positions) and its
    served tokens but the last.  Returns the logits (B, L - prefix + 1,
    vocab) fp32 at positions prefix-1 .. L-1: the reference's view of
    each served token."""
    device = tokens.device
    ctx = Ctx(Precision(precision), plan.dims, prefix)
    sch = schema(plan)
    w = _weights(["embed"], plan, seed, device)
    x = kind("embed").apply(w, tokens, ctx)
    for i, (mixer, ffn) in enumerate(plan.layers):
        for part, k in (("mixer", mixer), ("ffn", ffn)):
            if k is None:
                continue
            pre = f"layers.{i}.{part}."
            lw = _weights([n for n in sch if n.startswith(pre)], plan, seed,
                          device, strip=pre)
            x = x + plan.dims["residual_scale"] * kind(k).apply(lw, x, ctx)
            del lw
    hw = _weights([n for n in kind("head").params(plan.dims)], plan, seed,
                  device)
    if plan.dims["tied"]:
        hw["embed"] = ctx.prec.table(w["embed"])
    return kind("head").apply(hw, x[:, prefix - 1:], ctx)
