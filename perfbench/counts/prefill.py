"""The model FLOPs of one prefill of ``B`` prompts of ``S`` tokens: 2 per
parameter of a matrix product a token (of the routed experts only the k a
token picks, no capacity padding), 4 hd a visible (query, key) pair in
each attention layer, and the head at each prompt's last position.

``executed_plain`` counts instead what the port's plain path executes on
the CPU (every expert's capacity slots, every (query, key) pair, the
reference scan's products, the padded head), for holding this count
against ``FlopCounterMode`` in a test."""
from __future__ import annotations

import math

from perfbench import registry


def _kind(name):
    return registry.module("reference", name)


def products(plan):
    """(parameters of matrix products a token, routed-expert parameters a
    token, each MoE layer's (experts, capacity-slot parameters))."""
    dense = routed = 0
    moe = []
    dims = plan.dims
    for mixer, ffn in plan.layers:
        for k in (mixer, ffn):
            if k is None:
                continue
            mod, shapes = _kind(k), _kind(k).params(dims)
            dense += sum(math.prod(shapes[n].shape) for n in mod.PRODUCTS)
            experts = sum(math.prod(shapes[n].shape)
                          for n in getattr(mod, "EXPERTS", ()))
            if experts:
                routed += experts * dims["top_k"] // dims["experts"]
                moe.append(experts // dims["experts"])
    return dense, routed, moe


def n_kind(plan, kind):
    return sum(m == kind for m, _ in plan.layers)


def model_flops(plan, B, S) -> float:
    d = plan.dims
    dense, routed, _ = products(plan)
    pairs = B * S * (S + 1) // 2
    return (2.0 * (dense + routed) * B * S
            + n_kind(plan, "attention") * 4.0 * d["hd"] * d["heads"] * pairs
            + 2.0 * d["d"] * d["vocab"] * B)


def executed_plain(plan, B, S) -> float:
    d = plan.dims
    dense, _, moe = products(plan)
    out = 2.0 * dense * B * S
    for expert in moe:
        e, k = d["experts"], d["top_k"]
        cap = max(k, int(d["capacity_factor"] * B * S * k / e))
        out += 2.0 * expert * e * cap
    out += n_kind(plan, "attention") * 4.0 * d["hd"] * d["heads"] * B * S * S
    if n_kind(plan, "mamba"):
        out += n_kind(plan, "mamba") * 2.0 * B * S * d["expand"] * d["d"] \
            * d["d_state"]
    return out + 2.0 * d["d"] * d["padded_vocab"] * B
