"""RMSNorm as the port computes it: x / rms(x) * (1 + w)."""
from __future__ import annotations

import torch

from perfbench.weights import Param

STD = 0.1   # the drawn deviation of each norm weight from 1


def param(d: int) -> Param:
    return Param((d,), std=STD)


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        (1.0 + w.float())
