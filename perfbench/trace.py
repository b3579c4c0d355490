"""The traced slice of a ``--trace 1`` run, and what the metric readers
read from it.

``Tracer`` runs ``torch.profiler`` (host and device activity) over a fixed
slice of the window that the traffic file names, marks the harness's own
calls into the port with ``record_function`` ("perfbench.prefill",
"perfbench.decode_step", "perfbench.sample", all inside
"perfbench.slice"), and writes the Chrome trace to a temporary file,
which ``Trace.load`` reads and deletes.  Times are in microseconds on the
profiler's clock, which host and device events share.

A device operation is a kernel, a copy or a memset.  Each is tied to the
host call that launched it by its correlation id, so a kernel belongs to
the mark and the ``aten`` op whose host interval holds its launch.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


@dataclass
class Op:
    name: str
    start: float
    end: float
    cat: str = ""
    launch: Optional[float] = None      # host time of the launch, device ops

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    device: List[Op] = field(default_factory=list)   # sorted by start
    marks: List[Op] = field(default_factory=list)    # record_function ranges
    host: List[Op] = field(default_factory=list)     # aten ops, by start
    span: Tuple[float, float] = (0.0, 0.0)           # "perfbench.slice"

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            events = json.load(f)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return cls.from_events(events)

    @classmethod
    def from_events(cls, events: Iterable[dict]) -> "Trace":
        t = cls()
        launches: Dict[int, float] = {}
        device = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, start = e.get("cat", ""), float(e["ts"])
            op = Op(e.get("name", ""), start, start + float(e["dur"]), cat)
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                device.append((op, corr))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[corr] = start
            elif cat == "user_annotation":
                t.marks.append(op)
            elif cat == "cpu_op":
                t.host.append(op)
        for op, corr in device:
            op.launch = launches.get(corr)
        t.device = sorted((op for op, _ in device), key=lambda o: o.start)
        t.marks.sort(key=lambda o: o.start)
        t.host.sort(key=lambda o: o.start)
        spans = [m for m in t.marks if m.name == "perfbench.slice"]
        if spans:
            t.span = (spans[0].start, spans[-1].end)
        return t

    # -- reading ---------------------------------------------------------
    def kernels(self) -> List[Op]:
        return [o for o in self.device if o.cat == "kernel"]

    def marked(self, name: str) -> List[Tuple[Op, List[Op]]]:
        """Each mark ``name`` in the slice, in order, with the device ops
        launched inside it."""
        marks = [m for m in self.marks if m.name == name
                 and self.span[0] <= m.start <= self.span[1]]
        starts = [m.start for m in marks]
        out: List[Tuple[Op, List[Op]]] = [(m, []) for m in marks]
        for op in self.device:
            if op.launch is None:
                continue
            i = bisect.bisect_right(starts, op.launch) - 1
            if i >= 0 and op.launch <= marks[i].end:
                out[i][1].append(op)
        return out

    def inside_host(self, ops: Sequence[Op], host_name: str) -> List[Op]:
        """The device ops of ``ops`` launched inside an ``aten`` op named
        ``host_name`` (such ops do not nest)."""
        hs = [h for h in self.host if h.name == host_name]
        starts = [h.start for h in hs]
        out = []
        for op in ops:
            if op.launch is None:
                continue
            i = bisect.bisect_right(starts, op.launch) - 1
            if i >= 0 and op.launch <= hs[i].end:
                out.append(op)
        return out

    def busy(self) -> float:
        """Microseconds of the slice in which some device op ran."""
        lo, hi = self.span
        total, end = 0.0, lo
        for op in self.device:
            s, e = max(op.start, end), min(op.end, hi)
            if e > s:
                total += e - s
            end = max(end, min(op.end, hi))
        return total

    def gaps(self) -> List[Tuple[float, Optional[Op]]]:
        """Each idle stretch of the device in the slice: (microseconds,
        the device op that ended it, or None at the slice's end)."""
        lo, hi = self.span
        out, end = [], lo
        for op in self.device:
            if op.end <= lo or op.start >= hi:
                continue
            if op.start > end:
                out.append((op.start - end, op))
            end = max(end, op.end)
        if hi > end:
            out.append((hi - end, None))
        return out

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost mark and the
        innermost ``aten`` op whose interval holds it."""
        if not hasattr(self, "_inner"):
            marks = [m for m in self.marks if m.name != "perfbench.slice"]
            self._inner = [(ops, [o.start for o in ops])
                           for ops in (marks, self.host)]
        names = []
        for ops, starts in self._inner:
            best = None
            i = bisect.bisect_right(starts, t)
            for o in ops[max(0, i - 400):i]:
                if o.start <= t <= o.end and (best is None or
                                              o.dur < best.dur):
                    best = o
            if best is not None:
                names.append(best.name)
        return "/".join(names) or "host"


class Tracer:
    """Profiles one slice of a run; ``trace()`` gives its ``Trace``."""

    def __init__(self) -> None:
        self.prof = None
        self.slice = None
        self.result: Optional[Trace] = None

    @staticmethod
    def activities():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        loads the device tracer."""
        with torch.profiler.profile(activities=self.activities()):
            torch.zeros(1).add_(1)

    def mark(self, name: str):
        return torch.profiler.record_function(name)

    def begin(self) -> None:
        self.prof = torch.profiler.profile(activities=self.activities())
        self.prof.start()
        self.slice = self.mark("perfbench.slice")
        self.slice.__enter__()

    def end(self) -> None:
        self.slice.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()

    def trace(self) -> Optional[Trace]:
        if self.prof is None:
            return None
        if self.result is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                self.result = Trace.load(path)
            finally:
                os.unlink(path)
        return self.result

