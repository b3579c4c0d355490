"""Closed-loop static waves: the serving shape of the port's
``launch/serve.generate``, driven through its entries ``LM.prefill`` and
``LM.decode_step``.

A wave is ``batch`` requests with one prompt length (a wave has no
padding) and one number of new tokens.  Each wave starts when the one
before it has delivered its last token.  Tokens are greedy, and each is
brought to the host as a streaming server does: the next decode step is
enqueued first, then the host waits for the token before it, so the card
is not left waiting for the host.  A token's arrival is the host time at
which it is on the host.

Sizes come from the traffic file: ``levels`` prompt lengths spaced
log-uniformly from ``prompt.min`` to ``prompt.max`` (both included,
rounded to ``prompt.multiple``), and as many new-token counts from
``new_tokens``.  The order of sizes is fixed, the same for every seed, so
that every run does the same work and only the tokens change: block ``b``
of ``levels`` waves serves the prompt levels from the longest down, the
i-th of them with the new-token level ``levels - 1 - i - b`` (mod
``levels``), so the window's first wave is the largest and ``levels``
blocks pair every prompt level with every new-token level once.  The
tokens of a wave's prompts are drawn from (seed, wave).  Every wave's
cache holds ``prompt.max + new_tokens.max`` positions, as a server sizes
it for its largest request.
"""
from __future__ import annotations

import itertools
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class Wave:
    index: int                  # -1 for the warm-up wave
    prompt_len: int
    new_tokens: int
    start: float = 0.0          # host time the wave was submitted
    arrivals: List[float] = field(default_factory=list)  # a token step each
    enqueue: List[float] = field(default_factory=list)   # decode_step calls, s
    tokens: Optional[np.ndarray] = None     # (new_tokens, batch) served ids
    # (first, last) steps under the profiler: 0 is the prefill, i the
    # i-th decode step, -1 the last one; None when not profiled
    traced: Optional[Tuple[int, int]] = None


def _seed(seed: int) -> int:
    return int(seed) % 2 ** 64


def levels(spec: dict, k: int) -> List[int]:
    lo, hi, mult = spec["min"], spec["max"], spec.get("multiple", 1)
    out = []
    for i in range(k):
        v = lo * (hi / lo) ** (i / (k - 1)) if k > 1 else lo
        out.append(int(min(hi, max(lo, round(v / mult) * mult))))
    return out


def schedule(traffic: dict) -> Iterator[Tuple[int, int]]:
    """(prompt length, new tokens) of each wave, block after block."""
    k = traffic["levels"]
    ps, ns = levels(traffic["prompt"], k), levels(traffic["new_tokens"], k)
    for b in itertools.count():
        for i in range(k):
            yield ps[k - 1 - i], ns[(k - 1 - i - b) % k]


def prompts(traffic: dict, seed: int, index: int, length: int,
            vocab: int) -> np.ndarray:
    rng = np.random.default_rng([_seed(seed), 1, index + 1])
    return rng.integers(0, vocab, (traffic["batch"], length), dtype=np.int64)


def max_len(traffic: dict) -> int:
    return traffic["prompt"]["max"] + traffic["new_tokens"]["max"]


class Server:
    """Serves one wave at a time on ``model`` (the port's ``LM``)."""

    def __init__(self, model, traffic: dict, vocab: int, device,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self.model, self.vocab = model, vocab
        self.device, self.clock = torch.device(device), clock
        self.max_len = max_len(traffic)
        n, b = traffic["new_tokens"]["max"], traffic["batch"]
        cuda = self.device.type == "cuda"
        self.host = torch.empty((n, b), dtype=torch.int64, pin_memory=cuda)
        self.events = [torch.cuda.Event() for _ in range(n)] if cuda else None

    def _copy(self, i: int, tok) -> None:
        self.host[i].copy_(tok, non_blocking=self.events is not None)
        if self.events is not None:
            self.events[i].record()

    def _wait(self, i: int) -> float:
        if self.events is not None:
            self.events[i].synchronize()
        return self.clock()

    def _sample(self, logits):
        return logits[:, -1, :self.vocab].argmax(dim=-1)

    @torch.inference_mode()
    def wave(self, wave: Wave, tokens_np: np.ndarray, tracer=None,
             until: float = float("inf")) -> Wave:
        """Serve ``wave``; ``tracer`` profiles its steps ``wave.traced``.
        Past ``until`` (the window's end) no further step is enqueued: the
        wave is cut, and its ``tokens`` stay None."""
        model, S, n = self.model, wave.prompt_len, wave.new_tokens
        if tracer is None or wave.traced is None:
            tracer, first, last = None, -1, -1
        else:
            first, last = wave.traced
            last = n - 1 if last < 0 else min(last, n - 1)
            wave.traced = (first, last)
        mark = tracer.mark if tracer is not None else (lambda _: nullcontext())
        if tracer is not None and first == 0:
            tracer.begin()
        wave.start = self.clock()
        with mark("perfbench.prefill"):
            prompt = torch.from_numpy(tokens_np).to(self.device)
            logits, cache, _ = model.prefill({"tokens": prompt}, self.max_len)
        with mark("perfbench.sample"):
            tok = self._sample(logits)
            self._copy(0, tok)
        for i in range(1, n):
            if tracer is not None and i == first:
                tracer.begin()
            t0 = self.clock()
            with mark("perfbench.decode_step"):
                logits, cache = model.decode_step({"tokens": tok[:, None]},
                                                  cache, S + i - 1)
            wave.enqueue.append(self.clock() - t0)
            with mark("perfbench.sample"):
                tok = self._sample(logits)
                self._copy(i, tok)
            wave.arrivals.append(self._wait(i - 1))
            if tracer is not None and i - 1 == last:
                tracer.end()
                tracer = None
            if wave.arrivals[-1] >= until and i < n - 1:
                break
        wave.arrivals.append(self._wait(len(wave.arrivals)))
        if tracer is not None and first <= len(wave.arrivals) - 1:
            tracer.end()
        if len(wave.arrivals) == n:
            wave.tokens = self.host[:n].numpy().copy()
        del cache, logits
        return wave


WARM_STEPS = 16


def warm(server: Server, traffic: dict, seed: int) -> Wave:
    """One wave at the longest prompt the traffic serves, decoding at most
    ``WARM_STEPS`` tokens: it runs every kernel the window runs (a decode
    step runs the same kernels at every length) and leaves the allocator
    holding the largest blocks the window asks for (the cache always has
    ``max_len`` positions)."""
    S = traffic["prompt"]["max"]
    n = min(traffic["new_tokens"]["max"], WARM_STEPS)
    w = Wave(-1, S, n)
    return server.wave(w, prompts(traffic, seed, -1, S, server.vocab))


def traced_span(tr: dict, n: int) -> Tuple[int, int]:
    """(first, last) step that the trace spec ``tr`` names in a wave of
    ``n`` new tokens (0 is the prefill, -1 the last step): from the
    prefill if ``prefill``, through ``decode_steps`` decode steps (all if
    null); with ``at_end`` (and no prefill) the wave's last ones."""
    steps, at_end = tr.get("decode_steps"), tr.get("at_end", False)
    if tr.get("prefill", True):
        first = 0
    elif steps is not None and at_end:
        first = max(1, n - steps)
    else:
        first = 1
    return first, (-1 if steps is None or at_end else steps)


def run(server: Server, traffic: dict, seed: int, seconds: float,
        tracer=None) -> Tuple[List[Wave], float, float]:
    """Waves from now on until ``seconds`` have passed; the wave in flight
    then is cut, unless it is the first.  Returns (waves, window start,
    window end).
    With ``tracer``, the steps ``traffic["trace"]`` names of one wave are
    profiled."""
    tr = traffic.get("trace", {})
    traced_index = tr.get("wave", 0)
    waves: List[Wave] = []
    t_start = server.clock()
    t_end = t_start + seconds
    for index, (S, n) in enumerate(schedule(traffic)):
        if server.clock() >= t_end:
            break
        w = Wave(index, S, n)
        traced = tracer is not None and index == traced_index
        if traced:
            w.traced = traced_span(tr, n)
        # The window's first wave is never cut, so that a run always has
        # a finished wave to check however slow the host.
        server.wave(w, prompts(traffic, seed, index, S, server.vocab),
                    tracer if traced else None,
                    until=t_end if waves else float("inf"))
        waves.append(w)
    return waves, t_start, t_end
