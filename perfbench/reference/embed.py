"""The token embedding: a row of the table per token, times the model's
embedding scale (MiniCPM's scale_emb).  The table is drawn at the model's
``embed_std`` (0.02 unless its plan says otherwise)."""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.weights import Param


def params(dims) -> Dict[str, Param]:
    return {"embed": Param((dims["padded_vocab"], dims["d"]),
                           std=dims.get("embed_std", 0.02))}


def apply(w, tokens: torch.Tensor, ctx) -> torch.Tensor:
    return ctx.prec.table(w["embed"])[tokens] * ctx.dims["embed_scale"]
