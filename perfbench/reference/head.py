"""The output head: the final RMSNorm, the projection to the padded
vocabulary (the embedding table's transpose when tied), and the logits
divided by the model's divisor (MiniCPM's hidden / dim_model_base)."""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import norm
from perfbench.weights import Param


def params(dims) -> Dict[str, Param]:
    out = {"final_ln": norm.param(dims["d"])}
    if not dims["tied"]:
        d, v = dims["d"], dims["padded_vocab"]
        out["unembed"] = Param((d, v), std=d ** -0.5)
    return out


def apply(w, x: torch.Tensor, ctx) -> torch.Tensor:
    """x (B, n, d) -> logits (B, n, vocab) fp32, the padding cut off."""
    dims = ctx.dims
    h = norm.rms(x, w["final_ln"], dims["eps"])
    table = w["embed"].t() if dims["tied"] else w["unembed"]
    logits = ctx.prec.mm(h, table) / dims["logit_divisor"]
    return logits[..., :dims["vocab"]]
