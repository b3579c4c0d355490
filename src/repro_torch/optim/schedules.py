"""LR schedules: WSD (MiniCPM's Warmup-Stable-Decay) and cosine (port of
``repro.optim.schedules``), as fp32 scalars.  WSD gives 0 at step 0, as
the reference does (``src/repro/optim/schedules.py:14-18``)."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def wsd_schedule(step, *, warmup: int, stable: int, decay: int,
                 final_frac: float = 0.1) -> torch.Tensor:
    """MiniCPM WSD: linear warmup → constant → exponential-ish decay.

    Returns a multiplier in [0, 1] applied to the peak LR.
    """
    step = _f32(step)
    w, s, d = float(warmup), float(stable), float(decay)
    warm = step / max(w, 1.0)
    in_decay = torch.clamp((step - w - s) / max(d, 1.0), 0.0, 1.0)
    decay_mult = _f32(final_frac) ** in_decay     # exp decay to final_frac
    return torch.where(step < w, warm, decay_mult)


def cosine_schedule(step, *, warmup: int, total: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = step / max(float(warmup), 1.0)
    t = torch.clamp((step - warmup) / max(float(total - warmup), 1.0),
                    0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, cos)
