"""The dense SwiGLU feed-forward: (silu(h Wg) * (h Wu)) Wd of h = norm(x)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference import norm
from perfbench.weights import Param

ROWS = 8192     # tokens a block: the fp32 hidden is rows x d_ff
PRODUCTS = ("w_gate", "w_up", "w_down")


def params(dims) -> Dict[str, Param]:
    d, f = dims["d"], dims["d_ff"]
    return {"ln": norm.param(d),
            "w_gate": Param((d, f), std=d ** -0.5),
            "w_up": Param((d, f), std=d ** -0.5),
            "w_down": Param((f, d), std=f ** -0.5)}


def swiglu(prec, h, w_gate, w_up, w_down):
    return prec.mm(F.silu(prec.mm(h, w_gate)) * prec.mm(h, w_up), w_down)


def apply(w, x: torch.Tensor, ctx) -> torch.Tensor:
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for r in range(0, x.shape[0], ROWS):
        h = norm.rms(x[r:r + ROWS], w["ln"], ctx.dims["eps"])
        out[r:r + ROWS] = swiglu(ctx.prec, h, w["w_gate"], w["w_up"],
                                 w["w_down"])
    return out.reshape(shape)
