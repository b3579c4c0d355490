"""The least time of one decode step of ``B`` requests, each attending
``kv_len`` keys: the larger of its model FLOPs over the bf16 peak and the
bytes it must read and write once over the HBM rate.

FLOPs: 2 a parameter of a matrix product a token (the k picked experts),
4 hd a (query, key) pair, the head.  Bytes: every weight once, of each MoE
layer only the min(E, B k) experts a step can pick, of an untied
embedding table only the B rows looked up; K and V up to ``kv_len`` read
and the new token's written; the recurrent states read and written."""
from __future__ import annotations

import math

from perfbench import registry
from perfbench.reference import decoder


def step(plan, B, kv_len, itemsize=2):
    """(flops, bytes, least ms)."""
    d = plan.dims
    pf = registry.module("counts", "prefill")
    dense, routed, moe = pf.products(plan)
    n_attn, n_mamba = pf.n_kind(plan, "attention"), pf.n_kind(plan, "mamba")
    flops = (2.0 * (dense + routed) * B
             + n_attn * 4.0 * d["hd"] * d["heads"] * B * kv_len
             + 2.0 * d["d"] * d["vocab"] * B)
    weights = 0
    for name, p in decoder.schema(plan).items():
        n = math.prod(p.shape)
        if name == "embed" and not d["tied"]:
            n = B * d["d"]
        elif any(name.endswith(e) for e in ("moe.w_gate", "moe.w_up",
                                            "moe.w_down")):
            n = n // d["experts"] * min(d["experts"], B * d["top_k"])
        weights += itemsize * n
    kv = n_attn * 2 * itemsize * B * (kv_len + 1) * d["kv_heads"] * d["hd"]
    state = 0
    if n_mamba:
        di = d["expand"] * d["d"]
        state = n_mamba * 2 * (4 * B * di * d["d_state"]
                               + itemsize * B * (d["d_conv"] - 1) * di)
    nbytes = weights + kv + state
    ms, _ = registry.module("counts", "_peaks").least_ms(flops, nbytes)
    return flops, nbytes, ms
