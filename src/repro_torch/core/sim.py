"""Deterministic discrete-event simulation kernel.

The port's copy of ``repro/core/sim.py`` (the standard library only; the
port imports nothing of the JAX package).

A minimal simpy-style engine: processes are Python generators that yield
``Event`` objects and are resumed when the event triggers.  Everything is
driven off a single heap, so runs are bit-reproducible given a seed — which
is what lets the paper's latency figures and the hypothesis failure-schedule
property tests be deterministic on CPU.

Only the features the protocol needs are implemented:
  * ``sim.timeout(dt, value)``        – fires after dt
  * ``sim.event()``                   – manually triggered
  * ``sim.process(gen)``              – spawn; returns its done-Event
  * ``sim.timer(dt, fn)``             – cancellable callback (batch windows)
  * ``AnyOf`` / ``AllOf``             – composite waits (for vote collection
                                        with timeouts)
"""
from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, Generator, Iterable, List, Optional


class Event:
    __slots__ = ("sim", "triggered", "value", "callbacks")

    def __init__(self, sim: "Sim"):
        self.sim = sim
        self.triggered = False
        self.value: Any = None
        self.callbacks: List[Callable[["Event"], None]] = []

    def trigger(self, value: Any = None) -> "Event":
        if self.triggered:  # idempotent: late triggers are ignored
            return self
        self.triggered = True
        self.value = value
        # Defer callbacks through the queue so ordering is heap-deterministic.
        self.sim._schedule(self.sim.now, self._run_callbacks)
        return self

    def _run_callbacks(self) -> None:
        cbs, self.callbacks = self.callbacks, []
        for cb in cbs:
            cb(self)

    def subscribe(self, cb: Callable[["Event"], None]) -> None:
        if self.triggered:
            self.sim._schedule(self.sim.now, lambda: cb(self))
        else:
            self.callbacks.append(cb)

    def unsubscribe(self, cb: Callable[["Event"], None]) -> None:
        """Detach a callback registered with ``subscribe`` (no-op if it
        already ran or was never attached)."""
        try:
            self.callbacks.remove(cb)
        except ValueError:
            pass


class AnyOf(Event):
    """Triggers with (index, value) of the first sub-event to fire.

    The composite detaches itself from every sub-event the moment the
    first one fires: long-lived losers (e.g. a transport message slot
    that outlives thousands of timed-out waits) would otherwise keep the
    callback — and through it the whole composite — alive forever.
    """

    def __init__(self, sim: "Sim", events: Iterable[Event]):
        super().__init__(sim)
        self._subs: List = []
        for i, ev in enumerate(events):
            cb = (lambda e, i=i: self._first(i, e))
            self._subs.append((ev, cb))
            ev.subscribe(cb)

    def _first(self, i: int, ev: Event) -> None:
        if self.triggered:
            return
        self.trigger((i, ev.value))
        for sub, cb in self._subs:
            sub.unsubscribe(cb)
        self._subs = []


class AllOf(Event):
    """Triggers with the list of all sub-event values once all fired."""

    def __init__(self, sim: "Sim", events: Iterable[Event]):
        super().__init__(sim)
        self._events = list(events)
        self._pending = len(self._events)
        if self._pending == 0:
            self.trigger([])
        for ev in self._events:
            ev.subscribe(self._one_done)

    def _one_done(self, _ev: Event) -> None:
        self._pending -= 1
        if self._pending == 0 and not self.triggered:
            self.trigger([e.value for e in self._events])


class Timer:
    """Cancellable scheduled callback — the batch-window primitive.

    Unlike ``timeout`` (an Event processes yield on), a Timer is owned by
    infrastructure code that may need to disarm it before it fires: a
    group-commit lane cancels its window timer when the batch fills up or
    the lane flushes for another reason.
    """

    __slots__ = ("_fn", "cancelled")

    def __init__(self, sim: "Sim", delay: float, fn: Callable[[], None]):
        self._fn = fn
        self.cancelled = False
        sim._schedule(sim.now + max(0.0, delay), self._fire)

    def _fire(self) -> None:
        if not self.cancelled:
            self._fn()

    def cancel(self) -> None:
        self.cancelled = True


class Process(Event):
    """Drives a generator; the Process *is* its completion event."""

    def __init__(self, sim: "Sim", gen: Generator):
        super().__init__(sim)
        self._gen = gen
        sim._schedule(sim.now, lambda: self._step(None))

    def _step(self, send_value: Any) -> None:
        try:
            target = self._gen.send(send_value)
        except StopIteration as stop:
            self.trigger(stop.value)
            return
        if not isinstance(target, Event):
            raise TypeError(f"process yielded non-Event: {target!r}")
        target.subscribe(lambda ev: self._step(ev.value))


class Sim:
    def __init__(self) -> None:
        self.now: float = 0.0
        self._heap: list = []
        self._seq = itertools.count()

    # -- scheduling ---------------------------------------------------------
    def _schedule(self, at: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (at, next(self._seq), fn))

    def run(self, until: float = float("inf")) -> None:
        while self._heap and self._heap[0][0] <= until:
            at, _, fn = heapq.heappop(self._heap)
            self.now = max(self.now, at)
            fn()
        if until != float("inf"):
            self.now = max(self.now, until)

    # -- primitives ---------------------------------------------------------
    def event(self) -> Event:
        return Event(self)

    def timeout(self, dt: float, value: Any = None) -> Event:
        ev = Event(self)
        self._schedule(self.now + max(0.0, dt), lambda: ev.trigger(value))
        return ev

    def timer(self, dt: float, fn: Callable[[], None]) -> Timer:
        return Timer(self, dt, fn)

    def process(self, gen: Generator) -> Process:
        return Process(self, gen)

    def any_of(self, events: Iterable[Event]) -> AnyOf:
        return AnyOf(self, events)

    def all_of(self, events: Iterable[Event]) -> AllOf:
        return AllOf(self, events)
