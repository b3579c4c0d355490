"""Deterministic, resumable data pipeline.

The port's copy of ``repro/data/pipeline.py`` (the standard library
and numpy only; the port imports nothing of the JAX package).

Two sources:
  * ``SyntheticTokens`` — tokens are a pure function of (step, host), so any
    restart at step S reproduces the exact stream with zero state (this is
    the property that makes checkpoint-restart exact).
  * ``ByteCorpus``     — byte-level LM windows over a real file (examples
    train on the framework's own source code); windows are drawn by a
    counter-based RNG keyed on step, so it is stateless/resumable too.

``Prefetcher`` overlaps host-side batch assembly with device compute via a
background thread + bounded queue (the CPU analogue of the input pipeline
overlap you'd run on accelerator hosts).
"""
from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    batch: int = 8
    seq_len: int = 128
    vocab_size: int = 512
    source: str = "synthetic"      # synthetic | bytes:<path>
    seed: int = 0
    host: int = 0
    n_hosts: int = 1


class SyntheticTokens:
    """tokens[b, t] = hash(step, host, b, t) — fully stateless.

    Tokens are drawn from a fixed zipf-like unigram distribution
    (p ∝ 1/(rank+10)), NOT uniformly: a uniform stream sits exactly at the
    ln(vocab) cross-entropy floor, so "loss decreases" becomes a
    seed-dependent coin flip.  The skewed marginal keeps a robustly
    learnable signal (the model recovers the unigram bias within a few
    steps) while staying a pure function of (seed, host, step).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(cfg.vocab_size, dtype=np.float64)
        p = 1.0 / (ranks + 10.0)
        self._p = p / p.sum()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed, counter=[0, 0, cfg.host, step]))
        toks = rng.choice(cfg.vocab_size, size=(cfg.batch, cfg.seq_len),
                          p=self._p).astype(np.int32)
        return {"tokens": toks, "labels": toks.copy()}


class ByteCorpus:
    """Byte-level LM over a file; vocab = 256 (must fit cfg.vocab_size)."""

    def __init__(self, cfg: DataConfig, path: str):
        assert cfg.vocab_size >= 256, "byte LM needs vocab >= 256"
        with open(path, "rb") as f:
            self.data = np.frombuffer(f.read(), dtype=np.uint8)
        assert len(self.data) > cfg.seq_len + 1, "corpus too small"
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed ^ 0xC0FFEE, counter=[0, 0, cfg.host, step]))
        starts = rng.integers(0, len(self.data) - cfg.seq_len - 1, cfg.batch)
        toks = np.stack([self.data[s:s + cfg.seq_len] for s in starts])
        return {"tokens": toks.astype(np.int32),
                "labels": toks.astype(np.int32)}


def make_pipeline(cfg: DataConfig):
    if cfg.source == "synthetic":
        return SyntheticTokens(cfg)
    if cfg.source.startswith("bytes:"):
        return ByteCorpus(cfg, cfg.source.split(":", 1)[1])
    raise ValueError(f"unknown data source {cfg.source}")


class Prefetcher:
    """Background-thread prefetch of ``batch_at(step)`` with bounded depth."""

    def __init__(self, source, start_step: int, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.next_to_produce = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            batch = self.source.batch_at(self.next_to_produce)
            step = self.next_to_produce
            self.next_to_produce += 1
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self):
        return self.q.get()

    def stop(self):
        self._stop.set()
