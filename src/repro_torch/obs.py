"""Spans and counters inside the model step, on exactly while a torch
profiler records.

    with obs.step("decode_step", B=8, S=1, pos=611):   # an LM entry point
        with obs.span("attn", layer=3):                # a layer boundary
            ...
        obs.count("moe.kept", keep)                    # host int or tensor
    obs.counters()    # {"decode_step": {"moe.kept": 15, ...}}

``on()`` is ``torch.autograd.profiler._is_profiler_enabled``, which torch
sets while any ``torch.profiler.profile`` records, so profiling is the only
switch: there is no flag, variable or config field.  Off, a span is one
bool read and a shared no-op context manager, and a count is a bool read.
On, a span is ``torch.profiler.record_function("repro_torch.<name>")``: a
``user_annotation`` range in the same trace as the device activity, on its
clock, and each device op's launch falls under the innermost span whose
host interval holds it (its correlation id ties the two).  The attributes
go to ``record_function``'s ``args``.

Counters live in memory, one a name for each step kind (the ``obs.step``
that encloses the count, "(none)" outside every step).  A count never
syncs: a tensor is summed on its device inside a span named
``repro_torch.obs`` (a bool tensor's sum is two device ops, its cast and
its reduction) and the sum kept beside the others of its counter, so the
trace shows what counting cost.  ``counters()`` adds them up and syncs
once.  They hold the newest profiled session: a step entered while
profiling, after a step entered without, clears them.  A session run
straight after another, with no unprofiled step between, adds to its
counts.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, Optional, Union

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."
OFF = nullcontext()
NO_STEP = "(none)"


def on() -> bool:
    """Whether a torch profiler records now (read each call: torch flips
    the module attribute at every start and stop)."""
    return _profiler._is_profiler_enabled


def _args(attrs) -> Optional[str]:
    return ",".join(f"{k}={v}" for k, v in attrs.items()) or None


def span(name: str, **attrs):
    """``record_function("repro_torch.<name>")`` while a profiler records,
    else the shared no-op ``OFF`` (never an entered ``record_function``,
    which costs microseconds even with no profiler)."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return torch.profiler.record_function(PREFIX + name, _args(attrs))


class _Counters:
    """The accumulators and the step kind they are keyed by."""

    def __init__(self) -> None:
        self.kind = NO_STEP
        self.entered_on = False     # whether the last step entered profiled
        # {kind: {name: [host total, device sums...]}}
        self.acc: Dict[str, Dict[str, list]] = {}


_state = _Counters()


class _Step:
    """The span of one entry point, which keys the counts made inside it."""

    def __init__(self, kind: str, attrs) -> None:
        self.kind, self.prev = kind, NO_STEP
        self.rf = torch.profiler.record_function(PREFIX + kind, _args(attrs))

    def __enter__(self):
        self.prev, _state.kind = _state.kind, self.kind
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        _state.kind = self.prev
        return False


def step(kind: str, **attrs):
    """The span ``repro_torch.<kind>`` of an entry point ("prefill",
    "decode_step", "forward"); counts inside it are keyed by ``kind``.
    Entered while profiling after a step entered without, it clears the
    counts of the session before."""
    now = _profiler._is_profiler_enabled
    was, _state.entered_on = _state.entered_on, now
    if not now:
        return OFF
    if not was:
        _state.acc.clear()
    return _Step(kind, attrs)


def count(name: str, value: Union[int, torch.Tensor]) -> None:
    """Add ``value`` (a host int, or an integer or bool tensor, summed on
    its device) to counter ``name`` of the enclosing step kind, while a
    profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    parts = _state.acc.setdefault(_state.kind, {}).setdefault(name, [0])
    if not isinstance(value, torch.Tensor):
        parts[0] += int(value)
        return
    with span("obs"):
        parts.append(value.sum(dtype=torch.int64))


def counters() -> Dict[str, Dict[str, int]]:
    """{step kind: {counter: number}} of the newest profiled session; one
    sync a device for the counts made there."""
    out = {kind: {name: parts[0] for name, parts in c.items()}
           for kind, c in _state.acc.items()}
    sums = [(kind, name, torch.stack(parts[1:]).sum())
            for kind, c in _state.acc.items()
            for name, parts in c.items() if len(parts) > 1]
    for dev in {t.device for _, _, t in sums}:
        here = [(k, n, t) for k, n, t in sums if t.device == dev]
        values = torch.stack([t for _, _, t in here]).tolist()
        for (kind, name, _), x in zip(here, values):
            out[kind][name] += int(x)
    return out
