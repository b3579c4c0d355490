"""The routed mixture of experts as the port computes it, drops included.

h = norm(x); router probabilities softmax(h W_r) in fp32; each token's top
k experts, their gates renormalized to sum to 1.  Tokens are routed in
groups, as the port's served steps batch them: the prompt positions of
every request of the wave form one group (request-major order), and each
decode position forms a group of one token per request.  In a group of T
tokens an expert keeps at most C = max(k, int(cf * T * k / E)) of its
assignments, the first ones in (token, rank) order; a dropped assignment
adds nothing.  out = sum over kept assignments of gate * SwiGLU_e(h)."""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import ffn, norm
from perfbench.weights import Param

PRODUCTS = ("moe.router",)
EXPERTS = ("moe.w_gate", "moe.w_up", "moe.w_down")   # one of E a leaf


def params(dims) -> Dict[str, Param]:
    d, e, f = dims["d"], dims["experts"], dims["d_ff"]
    return {"ln": norm.param(d),
            "moe.router": Param((d, e), std=d ** -0.5),
            "moe.w_gate": Param((e, d, f), std=d ** -0.5),
            "moe.w_up": Param((e, d, f), std=d ** -0.5),
            "moe.w_down": Param((e, f, d), std=f ** -0.5)}


def route(prec, h, w, dims):
    """One group h (T, d) -> out (T, d) fp32."""
    T = h.shape[0]
    e, k, cf = dims["experts"], dims["top_k"], dims["capacity_factor"]
    probs = torch.softmax(prec.mm(h, w["moe.router"]), dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = max(k, int(cf * T * k / e))
    flat = ids.reshape(-1)                       # token-major, then rank
    out = torch.zeros_like(h)
    for x in range(e):
        mine = (flat == x).nonzero()[:, 0][:cap]  # the first C assignments
        if mine.numel() == 0:
            continue
        tok = mine // k
        y = ffn.swiglu(prec, h[tok], w["moe.w_gate"][x], w["moe.w_up"][x],
                       w["moe.w_down"][x])
        out.index_add_(0, tok, y * gates.reshape(-1)[mine, None])
    return out


def apply(w, x: torch.Tensor, ctx) -> torch.Tensor:
    B, L, d = x.shape
    S = ctx.prefix
    h = norm.rms(x, w["ln"], ctx.dims["eps"])
    out = torch.empty_like(h)
    out[:, :S] = route(ctx.prec, h[:, :S].reshape(B * S, d), w,
                       ctx.dims).view(B, S, d)
    for p in range(S, L):
        out[:, p] = route(ctx.prec, h[:, p], w, ctx.dims)
    return out
