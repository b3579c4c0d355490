"""Int8 gradient compression with error feedback (port of
``repro.optim.compress``).

Each gradient leaf is quantized to int8 with one fp32 scale per leaf before
the data-parallel all-reduce, and the quantization residual can be carried
in an error-feedback buffer so that its bias vanishes over steps.

A tree here is a ``{name: tensor}`` dict, the form ``launch.steps.
loss_and_grads`` gives; every tensor stays on its own device.  The
arithmetic and its order are the reference's:
  scale = max(max|g32|, 1e-12) / qmax
  q     = clip(round(g32 / scale), -qmax, qmax) as int8
  deq   = q.float() * scale
``torch.round`` rounds half to even, as ``jnp.round`` does, and both
divisions stay true divisions on every device (a product by the
reciprocal moves the scale by an ulp for some maxes, and with it the codes
at ties), so the codes and scales equal the JAX function's bit for bit on
the same fp32 gradients, on the card as on the CPU.  (Under ``jax.jit``
XLA itself turns the division by qmax into such a product, so the jitted
reference's scales can sit an ulp away.)

Used through ``launch.steps.make_train_step(..., compress=
CompressionConfig())``.  The reference's ``decompress_gradients`` takes a
``dtype`` that it never reads; the port leaves it out.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class CompressionConfig:
    bits: int = 8
    stochastic: bool = False  # deterministic rounding keeps tests exact


def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def compress_gradients(grads: Mapping[str, torch.Tensor],
                       cfg: CompressionConfig,
                       error_buf: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> Tuple[Tree, Tree, Mapping[str, torch.Tensor]]:
    """Quantize a gradient tree to int8 codes and per-leaf fp32 scales.

    Returns (codes, scales, pre): ``pre`` is what was quantized (the
    gradients plus ``error_buf`` when one is given, in fp32), from which
    ``error_feedback_update`` takes the residual after dequantization."""
    if error_buf is not None:
        grads = {n: g.float() + error_buf[n].float()
                 for n, g in grads.items()}
    qmax = _qmax(cfg.bits)
    q: Tree = {}
    scales: Tree = {}
    for name, g in grads.items():
        g32 = g.float()
        peak = torch.clamp(g32.abs().max(), min=1e-12)
        # A tensor divisor: CUDA multiplies by the reciprocal of a Python
        # number, an ulp off the quotient for about one max in twenty.
        scale = peak / torch.full_like(peak, qmax)
        q[name] = torch.clamp(torch.round(g32 / scale), -qmax,
                              qmax).to(torch.int8)
        scales[name] = scale
    return q, scales, grads


def decompress_gradients(q_tree: Mapping[str, torch.Tensor],
                         s_tree: Mapping[str, torch.Tensor]) -> Tree:
    return {n: q.float() * s_tree[n] for n, q in q_tree.items()}


def error_feedback_update(pre_quant_grads: Mapping[str, torch.Tensor],
                          dequantized: Mapping[str, torch.Tensor]) -> Tree:
    """Residual = what the quantizer lost this step (feeds the next one)."""
    return {n: g.float() - dequantized[n].float()
            for n, g in pre_quant_grads.items()}
