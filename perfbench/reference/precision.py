"""The precision a reference pass computes its matrix products in.

``float32``: both operands in fp32 with TF32 off, the reference itself.
``float8``: both operands rounded to ``float8_e4m3fn`` first (the weight
per output column, the activations per row, each scaled to the format's
largest value 448) and multiplied in fp32: an fp8 GEMM with fp32
accumulation, the step below the bf16 that the configurations state.  It
is the control that the comparison must fail.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 with one scale per slice along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    def __init__(self, name: str = "float32") -> None:
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., k) @ w (k, n) in fp32."""
        x, w = x.float(), w.float()
        if self.name == "float8":
            x, w = fp8_round(x, -1), fp8_round(w, 0)
        return x @ w

    def table(self, t: torch.Tensor) -> torch.Tensor:
        """An embedding table (rows are tokens) as this precision holds it."""
        t = t.float()
        return fp8_round(t, -1) if self.name == "float8" else t


def exact() -> None:
    """fp32 products in fp32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
