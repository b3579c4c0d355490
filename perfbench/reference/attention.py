"""Causal self-attention with grouped K/V heads and rotary positions, as
the port computes it: q, k, v = norm(x) W; rotate-half RoPE on q and k at
positions 0..L-1; softmax(q k^T / sqrt(hd)) over the keys at or before
each query; the output projected by Wo.  Query head h reads K/V head
h // (heads / kv_heads).  The whole sequence at once, so the K/V a decode
step reads from the port's cache is recomputed here from the tokens."""
from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference import norm
from perfbench.weights import Param

ROWS = 1024     # query rows a block: the scores are heads x ROWS x L fp32
PRODUCTS = ("wq", "wk", "wv", "wo")   # leaves read by matrix products


def params(dims) -> Dict[str, Param]:
    d, hq, hkv, hd = dims["d"], dims["heads"], dims["kv_heads"], dims["hd"]
    return {"ln": norm.param(d),
            "wq": Param((d, hq * hd), std=d ** -0.5),
            "wk": Param((d, hkv * hd), std=d ** -0.5),
            "wv": Param((d, hkv * hd), std=d ** -0.5),
            "wo": Param((hq * hd, d), std=(hq * hd) ** -0.5)}


def rope(L: int, hd: int, theta: float, device):
    """(cos, sin) of the angles pos / theta^(2i/hd), each (L, 1, hd/2)."""
    i = torch.arange(0, hd, 2, dtype=torch.float64) / hd
    inv = (1.0 / theta ** i).to(torch.float32).to(device)
    ang = torch.arange(L, dtype=torch.float32, device=device)[:, None] * inv
    return torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]


def rotate(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply(w, x: torch.Tensor, ctx) -> torch.Tensor:
    dims = ctx.dims
    B, L, _ = x.shape
    hq, hkv, hd = dims["heads"], dims["kv_heads"], dims["hd"]
    h = norm.rms(x, w["ln"], dims["eps"])
    q = ctx.prec.mm(h, w["wq"]).view(B, L, hq, hd)
    k = ctx.prec.mm(h, w["wk"]).view(B, L, hkv, hd)
    v = ctx.prec.mm(h, w["wv"]).view(B, L, hkv, hd)
    cos, sin = rope(L, hd, dims["theta"], x.device)
    q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    g = hq // hkv
    o = torch.empty((B, L, hq, hd), dtype=torch.float32, device=x.device)
    for b in range(B):
        kb = k[b].repeat_interleave(g, dim=1).transpose(0, 1)   # (hq, L, hd)
        vb = v[b].repeat_interleave(g, dim=1).transpose(0, 1)
        for r in range(0, L, ROWS):
            e = min(L, r + ROWS)
            qb = q[b, r:e].transpose(0, 1)                      # (hq, n, hd)
            s = qb @ kb[:, :e].transpose(1, 2) / math.sqrt(hd)  # (hq, n, e)
            later = torch.arange(e, device=x.device)[None, :] > \
                torch.arange(r, e, device=x.device)[:, None]
            s = s.masked_fill(later, float("-inf"))
            o[b, r:e] = (torch.softmax(s, dim=-1) @ vb[:, :e]).transpose(0, 1)
    return ctx.prec.mm(o.view(B, L, hq * hd), w["wo"])
