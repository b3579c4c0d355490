"""What the serving metrics share: the traced wave's prefill and decode
steps on the device's timeline.

A step ends when its token's copy to the host ends (the last device op of
its "perfbench.sample" mark).  The prefill starts with its first device
op (the prompt's copy to the card); a decode step starts where the step
before it ended, or, for the slice's first step, with its own first
device op.  Only steps whose token reached the host inside the slice
count.  Decode step i attends the prompt and i new tokens."""
from __future__ import annotations

from typing import List, Optional, Tuple


def _end(ops) -> Optional[float]:
    return max(o.end for o in ops) if ops else None


def _start(ops) -> Optional[float]:
    return min(o.start for o in ops) if ops else None


def prefill(run) -> Optional[Tuple[float, float]]:
    """(start, end) of the traced prefill in microseconds, or None."""
    t, w = run.trace, run.traced_wave
    if t is None or w is None or w.traced[0] != 0:
        return None
    pre, samples = t.marked("perfbench.prefill"), t.marked("perfbench.sample")
    if not pre or not samples:
        return None
    start, end = _start(pre[0][1]), _end(samples[0][1])
    if start is None or end is None or end > t.span[1]:
        return None
    return start, end


def decode_steps(run) -> List[Tuple[int, float, float]]:
    """(i, start, end) in microseconds of each traced decode step."""
    t, w = run.trace, run.traced_wave
    if t is None or w is None:
        return []
    first = w.traced[0]
    steps = t.marked("perfbench.decode_step")
    samples = t.marked("perfbench.sample")
    # The slice's samples start at the prefill's when it is traced.
    offset = 0 if first == 0 else first
    ends = {offset + j: _end(ops) for j, (_, ops) in enumerate(samples)}
    out, i0 = [], max(first, 1)
    for j, (_, ops) in enumerate(steps):
        i = i0 + j
        end = ends.get(i)
        if end is None or end > t.span[1]:
            break
        start = ends.get(i - 1) or _start(ops)
        if start is None:
            break
        out.append((i, start, end))
    return out


def kernels_between(run, pattern: str, lo: float, hi: float):
    """Kernels whose name matches ``pattern`` that ran within [lo, hi]."""
    import re
    return [k for k in run.trace.kernels()
            if lo <= k.start and k.end <= hi and re.search(pattern, k.name)]
