"""The end-to-end arithmetic, on the host's clock, over every request and
every token of the window: nothing is taken from medians of chunks."""
from __future__ import annotations

import math
from typing import Dict, List, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    xs = sorted(values)
    if not xs:
        return math.nan
    h = (len(xs) - 1) * q / 100.0
    lo = math.floor(h)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (h - lo) * (xs[hi] - xs[lo])


def serving(waves, t_start: float, t_end: float, batch: int
            ) -> Dict[str, float]:
    """From each wave's submission time and token arrivals (one arrival a
    token step, shared by the wave's ``batch`` requests):
      output_tokens_per_s  tokens on the host by the window's end, over it
      ttft_p95_ms          over requests whose first token came in it
      tpot_p95_ms          over gaps between a request's tokens that
                           ended in it"""
    tokens = 0
    ttft: List[float] = []
    gaps: List[float] = []
    for w in waves:
        arr = w.arrivals
        inside = [a for a in arr if t_start <= a <= t_end]
        tokens += batch * len(inside)
        if arr and t_start <= arr[0] <= t_end:
            ttft += [arr[0] - w.start] * batch
        gaps += [b - a for a, b in zip(arr, arr[1:])
                 if t_start <= b <= t_end] * batch
    seconds = t_end - t_start
    return {"output_tokens_per_s": tokens / seconds,
            "ttft_p95_ms": 1e3 * percentile(ttft, 95),
            "tpot_p95_ms": 1e3 * percentile(gaps, 95),
            "requests": len(ttft), "gaps": len(gaps)}

