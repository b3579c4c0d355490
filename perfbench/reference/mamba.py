"""The mamba mixer (selective SSM) as the port computes it.

xs, z = halves of norm(x) W_in; a causal depthwise conv of width K over
time (the conv's last tap on the current token), then silu: u; from u W_bcdt
the state inputs b, c (N each) and dt_in (dt_rank); dt = softplus(dt_in
W_dt + dt_bias); a = -exp(a_log).  The recurrence, one token after
another from a zero state, in fp32:
    h_t = exp(dt_t a) * h_{t-1} + dt_t b_t u_t,   y_t = h_t . c_t
and out = ((y + u * d_skip) * silu(z)) W_out.  The whole sequence at
once: the port's conv and SSM states after the prompt are the values this
recurrence passes on, so its decode steps are checked by the same pass."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference import norm
from perfbench.weights import Param

CHUNK = 64      # time steps whose decays are formed at once
PRODUCTS = ("w_in", "w_bcdt", "w_dt", "w_out")


def params(dims) -> Dict[str, Param]:
    d, n, k, r = dims["d"], dims["d_state"], dims["d_conv"], dims["dt_rank"]
    di = dims["expand"] * d
    return {"ln": norm.param(d),
            "w_in": Param((d, 2 * di), std=d ** -0.5),
            "conv": Param((k, di), std=0.1),
            "w_bcdt": Param((di, 2 * n + r), std=di ** -0.5),
            "w_dt": Param((r, di), std=0.5),
            "dt_bias": Param((di,), std=0.5),
            "a_log": Param((di, n), init="log_uniform", lo=1.0, hi=16.0),
            "d_skip": Param((di,), std=0.1, mean=1.0),
            "w_out": Param((di, d), std=di ** -0.5)}


def scan(u, dt, a, b, c):
    """u, dt (B, L, di), a (di, N), b, c (B, L, N) -> y (B, L, di)."""
    B, L, di = u.shape
    h = torch.zeros((B, di, a.shape[1]), dtype=torch.float32,
                    device=u.device)
    y = torch.empty((B, L, di), dtype=torch.float32, device=u.device)
    for t0 in range(0, L, CHUNK):
        t1 = min(L, t0 + CHUNK)
        dtc = dt[:, t0:t1].transpose(0, 1)[..., None]            # (c,B,di,1)
        decay = torch.exp(dtc * a)                               # (c,B,di,N)
        push = (dtc * u[:, t0:t1].transpose(0, 1)[..., None]) * \
            b[:, t0:t1].transpose(0, 1)[:, :, None, :]
        hs = torch.empty_like(decay)
        for t in range(t1 - t0):
            h = torch.addcmul(push[t], decay[t], h, out=hs[t])
        y[:, t0:t1] = torch.einsum("tbdn,tbn->btd", hs,
                                   c[:, t0:t1].transpose(0, 1))
    return y


def apply(w, x: torch.Tensor, ctx) -> torch.Tensor:
    dims = ctx.dims
    B, L, _ = x.shape
    n, K = dims["d_state"], dims["d_conv"]
    h = norm.rms(x, w["ln"], dims["eps"])
    xs, z = ctx.prec.mm(h, w["w_in"]).chunk(2, dim=-1)
    xin = F.pad(xs, (0, 0, K - 1, 0))
    u = F.silu(sum(xin[:, i:i + L] * w["conv"][i] for i in range(K)))
    b, c, dt_in = ctx.prec.mm(u, w["w_bcdt"]).split(
        [n, n, dims["dt_rank"]], dim=-1)
    dt = F.softplus(ctx.prec.mm(dt_in, w["w_dt"]) + w["dt_bias"])
    y = scan(u, dt, -torch.exp(w["a_log"]), b, c)
    return ctx.prec.mm((y + u * w["d_skip"]) * F.silu(z), w["w_out"])
