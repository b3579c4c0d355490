"""Continuous batching on the port's kernel decode backend (CPU tensors).

``KernelDecode(device="cpu")`` runs the plain version of ``flash_decode``;
the batcher, the slot pool and the stand-in draws are the same code the
card runs.
"""
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.serve import (AdmissionConfig, ContinuousBatcher,  # noqa: E402
                               KernelDecode, StepRequest, StubDecode,
                               make_decode)

SESSIONS = [f"s{i}" for i in range(6)]
STEPS = 5


def drive_lockstep(max_batch: int):
    """Every session submits step t, all wait, then step t+1: all sessions
    hold the same cache length whatever the batching, so the one scalar
    kv_len is each session's own."""
    decode = KernelDecode(slots=8, q_heads=4, kv_heads=2, head_dim=16,
                          max_len=32, seed=1, device="cpu")
    batcher = ContinuousBatcher(decode, AdmissionConfig(
        max_batch=max_batch, window_ms=20.0)).start()
    out = {s: [] for s in SESSIONS}
    try:
        for t in range(STEPS):
            reqs = [StepRequest(s, 100 + t) for s in SESSIONS]
            for r in reqs:
                assert batcher.submit(r)
            for r in reqs:
                assert r.done.wait(timeout=10.0)
                assert not r.dropped
                out[r.session].append(r.result)
    finally:
        batcher.stop()
    return out, batcher


def test_batched_equals_unbatched():
    batched, b = drive_lockstep(max_batch=8)
    unbatched, u = drive_lockstep(max_batch=1)
    assert batched == unbatched
    assert u.max_batch_seen == 1 and b.max_batch_seen > 1
    assert b.decoded == u.decoded == len(SESSIONS) * STEPS
    assert b.dropped == u.dropped == 0


def test_one_flash_decode_per_batch_with_max_len(monkeypatch):
    from repro_torch.serve import admission
    calls = []
    real = admission.ops.flash_decode

    def spy(q, k, v, kv_len, **kw):
        calls.append((q.shape[0], k.shape, kv_len))
        return real(q, k, v, kv_len, **kw)

    monkeypatch.setattr(admission.ops, "flash_decode", spy)
    dec = KernelDecode(slots=4, q_heads=4, kv_heads=2, head_dim=16,
                       max_len=8, device="cpu")
    dec([StepRequest("a", 1)])
    dec([StepRequest("a", 2)])
    dec([StepRequest("a", 3), StepRequest("b", 1)])
    assert calls == [(1, (1, 2, 8, 16), 1), (1, (1, 2, 8, 16), 2),
                     (2, (2, 2, 8, 16), 3)]


def test_slot_recycling_and_release_match_jax_semantics():
    """The same register/release sequence through the JAX package's
    ``PallasDecode`` pool bookkeeping and the port's gives the same slots
    and lengths."""
    pytest.importorskip("jax")
    from repro.serve.admission import PallasDecode
    jdec = PallasDecode(slots=3, q_heads=2, kv_heads=1, head_dim=8,
                        max_len=4)
    tdec = KernelDecode(slots=3, q_heads=2, kv_heads=1, head_dim=8,
                        max_len=4, device="cpu")
    script = ["a", "b", "c", "d", "b", ("rel", "c"), "e", "f", ("rel", "zz"),
              ("rel", "a"), "g", "a"]
    for step in script:
        for dec in (jdec, tdec):
            if isinstance(step, tuple):
                dec.release(step[1])
            else:
                slot = dec._slot_of(step)
                dec._lens[slot] += 1
        assert tdec._by_session == jdec._by_session
        assert tdec._lens == jdec._lens
        assert sorted(tdec._free) == sorted(jdec._free)


def test_full_pool_recycles_and_clamps_at_max_len():
    dec = KernelDecode(slots=2, q_heads=2, kv_heads=1, head_dim=8, max_len=3,
                       device="cpu")
    for t in range(5):                       # past max_len: clamps, no error
        dec([StepRequest("a", t)])
    assert dec._lens[dec._by_session["a"]] == 3
    dec([StepRequest("b", 0)])
    dec([StepRequest("c", 0)])               # pool full: recycles a slot
    assert len(dec._by_session) == 2 and "c" in dec._by_session
    assert dec._lens[dec._by_session["c"]] == 1


class _FailOnce:
    def __init__(self, inner):
        self.inner = inner
        self.failed = threading.Event()

    def __call__(self, reqs):
        if not self.failed.is_set():
            self.failed.set()
            raise RuntimeError("injected decode failure")
        return self.inner(reqs)


def test_failed_decode_drops_batch_and_loop_continues():
    dec = _FailOnce(KernelDecode(slots=4, q_heads=2, kv_heads=1, head_dim=8,
                                 max_len=8, device="cpu"))
    batcher = ContinuousBatcher(dec, AdmissionConfig(max_batch=4,
                                                     window_ms=1.0)).start()
    try:
        first = StepRequest("a", 1)
        assert batcher.submit(first)
        assert first.done.wait(timeout=10.0)
        assert first.dropped and first.result is None
        assert isinstance(batcher.last_error, RuntimeError)
        second = StepRequest("a", 2)
        assert batcher.submit(second)
        assert second.done.wait(timeout=10.0)
        assert not second.dropped and isinstance(second.result, int)
    finally:
        batcher.stop()
    assert (batcher.dropped, batcher.decoded) == (1, 1)


def test_make_decode_has_no_auto():
    with pytest.raises(ValueError, match="unknown decode backend"):
        make_decode("auto")
    with pytest.raises(ValueError):
        make_decode("pallas")
    assert isinstance(make_decode("stub"), StubDecode)
    assert isinstance(make_decode("kernel", device="cpu", slots=2),
                      KernelDecode)
