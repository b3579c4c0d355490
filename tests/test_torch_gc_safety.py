"""Twin of ``tests/test_gc_safety.py`` on the port's modules
(``repro_torch.core`` / ``repro_torch.txn``): the same assertions, seeds,
parametrisations and hypothesis settings.

Safety of the durable-state lifecycle: invisibility, AC-GC, anti-resurrection.

Three property families from the lifecycle design:

  1. Bit-invisibility — arming the lifecycle layer (checksums, and in
     fault-free runs even GC + scrub) changes NOTHING observable about a
     healthy benchmark run: same commits, same aborts, same latency, same
     certified history.
  2. AC-GC under chaos — random fault schedules that mix bit-rot, torn
     tails and GC-pulse truncation with crashes and network loss still
     certify AC1–AC3 + writer-of + recoverability + AC-GC with zero
     violations (regression seeds from development are pinned).
  3. Anti-resurrection — once the watermark truncates a slot cluster-wide,
     no scrub repair, state transfer, or late LogOnce can bring a
     conflicting value back: the GC journal's decision is the tombstone.

``benchmarks/`` belongs to the reference, so ``chaos_run_one`` (in
``tests/twopc_scan.py``) is the port's copy of ``benchmarks/chaos.run_one``
built from the port's ``FaultSchedule``, ``BenchConfig`` and ``run_bench``;
``test_chaos_run_one_matches_the_reference`` holds it to the reference's
with ``==``, field by field, and the anti-resurrection and ``MemoryStore``
cases also run on the JAX package's stores and compare.

Deliberate divergences (ROADMAP "Deliberate divergences"): the port's
2PC does not decide both ways where the reference's does.  Its rules:
  * a node forcing its commit record or its YES vote answers a peer's
    decision request "unknown" instead of presuming abort;
  * a node that presumed abort for an attempt votes ABORT in it, or, as
    its coordinator, decides ABORT;
  * a restarted coordinator whose dead incarnation was forcing its commit
    record presumes abort through its own slot, and decides what the slot
    answers (``recover`` likewise decides what its decision write
    answers);
  * a plain ``log`` on the replicated sim store answers the decision a
    quorum of the slot's replicas holds.
``REPAIRED`` pins, per chaos cell, the reference's violations and holds
the port's at none (``test_rot_mix_repaired_seeds_diverge_from_reference``);
``test_prop_twopc_mixes_certify`` draws 2PC cells of every fault mix, and
the slow ``test_twopc_scan_certifies`` runs ``tests/twopc_scan.GRID``.
These tests import no torch: the port's commit core is standard library
only.
"""
from __future__ import annotations

import dataclasses
import random

import pytest

from conftest import hypothesis_or_stubs

import repro.core.lifecycle as jlifecycle
import repro.core.state as jstate
import repro.core.storage as jstorage
import repro_torch.core.lifecycle as tlifecycle
import repro_torch.core.state as tstate
import repro_torch.core.storage as tstorage
from benchmarks.chaos import run_one as reference_run_one
from repro_torch.core import AZURE_REDIS, Vote
from repro_torch.core.lifecycle import LifecycleConfig
from repro_torch.core.protocols import registered_protocols
from repro_torch.core.storage import MemoryStore, ReplicatedStore
from repro_torch.txn import BenchConfig, YCSBWorkload, run_bench
from twopc_scan import GRID, OTHER_MIXES, chaos_run_one, run_cell

HAS_HYPOTHESIS, given, settings, st = hypothesis_or_stubs()
# (storage, lifecycle, state) modules of each package's commit core.
PORT = (tstorage, tlifecycle, tstate)
REFERENCE = (jstorage, jlifecycle, jstate)

ARMED = dict(checksums=True, gc=True, scrub=True,
             gc_interval_ms=25.0, scrub_interval_ms=40.0)
# The lifecycle's own observability surface: these move when it is armed
# (watermark_lag counts retained slots); everything else must not.
LIFECYCLE_KEYS = frozenset({"gc_truncations", "watermark_lag",
                            "scrub_repairs", "quarantines",
                            "corrupt_records", "torn_records"})

def _foreground(res) -> dict:
    return {k: v for k, v in res.breakdown().items()
            if k not in LIFECYCLE_KEYS}


def _bench(proto: str, lifecycle, seed: int = 5, horizon_ms: float = 200.0,
           replication: int = 1):
    def wl(nodes, seed):
        return YCSBWorkload(nodes, seed=seed)
    cfg = BenchConfig(protocol=proto, n_nodes=4, threads_per_node=2,
                      horizon_ms=horizon_ms, seed=seed,
                      replication=replication, record_history=True,
                      lifecycle=lifecycle)
    return run_bench(wl, AZURE_REDIS, cfg)


# ---------------------------------------------------------------------------
# 1. Bit-invisibility
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("proto", registered_protocols())
def test_checksums_only_is_bit_invisible(proto):
    """lifecycle=None vs checksums-only framing: identical breakdown."""
    off = _bench(proto, None)
    framed = _bench(proto, dict(checksums=True))
    assert _foreground(framed) == _foreground(off)
    assert framed.corrupt_records == 0 and framed.torn_records == 0


@pytest.mark.parametrize("proto", ["cornus", "2pc", "cl"])
@pytest.mark.parametrize("replication", [1, 3])
def test_armed_lifecycle_invisible_on_healthy_runs(proto, replication):
    """Full GC + scrub on a fault-free run: the foreground outcome is
    untouched; only the maintenance counters move.  At R=1 the armed run
    is result-identical; at R=3 the background cadence perturbs event-tie
    ordering in the scheduler, so the bound is a tight tolerance instead
    of exact equality (the bit-exactness contract is lifecycle=OFF, which
    the bench gates pin)."""
    off = _bench(proto, None, replication=replication)
    on = _bench(proto, dict(ARMED), replication=replication)
    if replication == 1:
        assert on.commits == off.commits
        assert on.aborts == off.aborts
        assert on.throughput_tps == off.throughput_tps
        assert on.avg_latency_ms == off.avg_latency_ms
        assert on.scrub_repairs == 0   # single volume: nothing diverges
    else:
        assert abs(on.commits - off.commits) <= max(3, off.commits * 0.05)
    assert on.gaveups == off.gaveups == 0
    assert on.violations == 0 and off.violations == 0
    # Scrub may catch up stale minority copies at R>1 (quorum writes skip
    # a replica legitimately) — but never quarantines a healthy volume.
    assert on.quarantines == 0
    assert on.gc_truncations > 0       # GC ran and settled txns
    assert on.corrupt_records == 0 and on.torn_records == 0


if HAS_HYPOTHESIS:
    @given(st.integers(min_value=0, max_value=10_000),
           st.sampled_from(registered_protocols()))
    @settings(max_examples=10, deadline=None)
    def test_prop_checksums_invisible(seed, proto):
        off = _bench(proto, None, seed=seed, horizon_ms=120.0)
        framed = _bench(proto, dict(checksums=True), seed=seed,
                        horizon_ms=120.0)
        assert _foreground(framed) == _foreground(off)


# ---------------------------------------------------------------------------
# 2. AC-GC under random chaos + truncation (the "rot" fault mix)
# ---------------------------------------------------------------------------
# Regression cells from development: seeds that exposed the truncation/
# recovery race (cornus R3) and the zombie decision re-issue (2pc R1),
# plus generic coverage of both protocols at both replication levels.
ROT_CELLS = [
    ("cornus", 3, 0), ("cornus", 3, 3), ("cornus", 3, 5),
    ("2pc", 1, 8),
    ("cornus", 1, 2), ("2pc", 3, 1),
]
# 2PC, horizon 200: (mix, R, seed) -> the reference's violation count,
# one cell for each path by which the reference decides both ways:
#  - rot 4352, 61, 129: a coordinator forcing its commit record presumes
#    abort on its own behalf, then commits;
#  - rot 548 (R = 1) and 254 (R = 3): a restarted coordinator whose
#    commit record landed presumes abort without reading it;
#  - rot 599, messages 5, torn 22 (R = 3): a node forcing its YES vote
#    presumes abort, then votes YES;
#  - crash 42 (R = 3): a recovering coordinator ignores the COMMIT its
#    presumed-abort write meets, and the replicated store answers ABORT
#    over it.
REPAIRED = {("rot", 1, 4352): 1, ("rot", 1, 61): 1, ("rot", 1, 129): 4,
            ("rot", 1, 548): 4, ("rot", 3, 254): 4, ("rot", 1, 599): 4,
            ("messages", 1, 5): 3, ("torn", 3, 22): 3, ("crash", 3, 42): 1}
# 2PC cells where the reference reports no violation but its coordinator
# told its client COMMIT while another node decided ABORT (the history
# checker reads a node's live decision before its recorded outcome):
# (mix, R, seed) -> the reference's client-acknowledgement violations.
SILENT_SPLITS = {("rot", 1, 32): 1, ("messages", 1, 4): 1}


@pytest.mark.parametrize("proto,replication,seed", ROT_CELLS)
def test_rot_mix_certifies_zero_violations(proto, replication, seed):
    res, _sched, _config = chaos_run_one(proto, "rot", replication, seed,
                                         horizon_ms=300.0)
    assert res.violations == 0, res.violation_details
    assert res.commits > 0                   # chaos may slow, not stop
    assert res.gc_truncations > 0            # truncation pulses did fire


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("proto", ["cornus", "2pc"])
@pytest.mark.parametrize("replication", [1, 3])
def test_rot_mix_sweep_slow(proto, replication, seed):
    res, _sched, _config = chaos_run_one(proto, "rot", replication, seed,
                                         horizon_ms=300.0)
    assert res.violations == 0, res.violation_details


if HAS_HYPOTHESIS:
    @given(st.integers(min_value=0, max_value=100_000),
           st.sampled_from(["cornus", "2pc"]),
           st.sampled_from([1, 3]))
    @settings(max_examples=8, deadline=None)
    def test_prop_rot_mix_certifies(seed, proto, replication):
        res, _s, _c = chaos_run_one(proto, "rot", replication, seed,
                                    horizon_ms=200.0)
        assert res.violations == 0, res.violation_details


def _cell_id(mix: str, replication: int, seed: int) -> str:
    # The first three repaired rot cells keep their ids (the seed alone).
    if (mix, replication) == ("rot", 1) and seed in (4352, 61, 129):
        return str(seed)
    return f"{mix}-{replication}-{seed}"


@pytest.mark.parametrize("mix,replication,seed",
                         [pytest.param(*c, id=_cell_id(*c))
                          for c in sorted(REPAIRED)])
def test_rot_mix_repaired_seeds_diverge_from_reference(mix, replication,
                                                       seed):
    """Where the port parts from the reference on purpose: in these cells
    the reference's 2PC decides both ways (its violation count is pinned
    here), and the port's certifies, with commits, GC truncations under
    "rot", and a clean client-acknowledgement check."""
    ref, _s, _c = reference_run_one("2pc", mix, replication, seed,
                                    horizon_ms=200.0)
    assert ref.violations == REPAIRED[(mix, replication, seed)], \
        ref.violation_details
    res, ack, _blocked = run_cell("port", "2pc", mix, replication, seed)
    assert res.violations == 0, res.violation_details
    assert ack == []
    assert res.commits > 0
    if mix == "rot":
        assert res.gc_truncations > 0


@pytest.mark.parametrize("mix,replication,seed", sorted(SILENT_SPLITS))
def test_silent_splits_are_repaired(mix, replication, seed):
    """The reference's checker passes these cells, but its coordinator
    told its client COMMIT while other nodes decided ABORT; the port's
    client-acknowledgement check is clean."""
    ref, ref_ack, _blocked = run_cell("reference", "2pc", mix, replication,
                                      seed)
    assert ref.violations == 0
    assert len(ref_ack) == SILENT_SPLITS[(mix, replication, seed)], ref_ack
    res, ack, _blocked = run_cell("port", "2pc", mix, replication, seed)
    assert res.violations == 0 and ack == [], (res.violation_details, ack)
    assert res.commits > 0


if HAS_HYPOTHESIS:
    @given(st.integers(min_value=0, max_value=100_000),
           st.sampled_from(("rot",) + OTHER_MIXES),
           st.sampled_from([1, 3]))
    @settings(max_examples=8, deadline=None)
    def test_prop_twopc_mixes_certify(seed, mix, replication):
        """2PC under every fault mix of the scan, whose port cells all
        certify: no violation and a clean client-acknowledgement check."""
        res, ack, _blocked = run_cell("port", "2pc", mix, replication, seed)
        assert res.violations == 0, res.violation_details
        assert ack == []


@pytest.mark.slow
@pytest.mark.parametrize("proto,mix,replication", sorted(GRID))
def test_twopc_scan_certifies(proto, mix, replication):
    """The scan of ``tests/twopc_scan.py`` on the port, one (protocol,
    mix, R) at a time: every seed certifies with a clean
    client-acknowledgement check."""
    bad = []
    for seed in GRID[(proto, mix, replication)]:
        res, ack, _blocked = run_cell("port", proto, mix, replication, seed)
        if res.violations or ack:
            bad.append((seed, res.violation_details[:1] + ack[:1]))
    assert bad == []


# Every ROT_CELLS entry at the regression tests' horizon, and a cell of
# each mix that runs with the lifecycle off, so both branches of the copy
# are held to the reference.
PARITY_CELLS = ([(p, "rot", r, s, 300.0) for p, r, s in ROT_CELLS]
                + [("cornus", "rot", 3, 9, 200.0), ("2pc", "rot", 1, 3, 200.0),
                   ("cornus", "messages", 1, 7, 200.0),
                   ("2pc", "partition", 3, 7, 200.0),
                   ("2pc", "crash", 1, 4, 200.0),
                   ("cornus", "full", 3, 7, 200.0)])


@pytest.mark.parametrize("proto,mix,replication,seed,horizon", PARITY_CELLS)
def test_chaos_run_one_matches_the_reference(proto, mix, replication, seed,
                                             horizon):
    """The copy of ``benchmarks/chaos.run_one``: every ``BenchResult``
    field, the schedule and the bundle config equal the reference's."""
    res, sched, config = chaos_run_one(proto, mix, replication, seed,
                                       horizon_ms=horizon)
    ref, rsched, rconfig = reference_run_one(proto, mix, replication, seed,
                                             horizon_ms=horizon)
    assert dataclasses.asdict(res) == dataclasses.asdict(ref)
    assert sched.to_dict() == rsched.to_dict()
    assert config == rconfig


# ---------------------------------------------------------------------------
# 3. Anti-resurrection
# ---------------------------------------------------------------------------
def _settled_store(lifecycle=None, pkg=PORT) -> ReplicatedStore:
    """R=3 threaded store with a few settled txns per partition."""
    storage, lcmod, state = pkg
    lc = lifecycle or lcmod.LifecycleConfig(**ARMED)
    store = storage.ReplicatedStore(3, seed=1, lifecycle=lc)
    for p in ("p0", "p1"):
        for t in range(4):
            store.log_once(p, f"t{t}", state.Vote.VOTE_YES, writer=p)
            store.log(p, f"t{t}", state.Vote.COMMIT if t % 2
                      else state.Vote.ABORT, writer=p)
    return store


def test_state_transfer_never_resurrects_truncated_slots():
    store = _settled_store()
    assert store.gc_pass() == 8
    truncated = list(store._gc_index)
    assert truncated
    # Plant zombie copies on replica 2 — a rejoiner whose disk still holds
    # (or re-acquired) pre-truncation slots, with the WRONG decision.
    for k in truncated:
        store.replicas[2].repair(k, Vote.COMMIT, 99, True)
    store._state_transfer(2, store._membership.replica_ids)
    for k in truncated:
        assert k not in store.replicas[2].keys()
        # The journal, not the zombie, answers late ops.
        want = Vote(store._gc_index[k].decision)
        assert store.read_state(*k) == want
        assert store.log_once(*k, Vote.COMMIT, writer="n9") == want


def test_scrub_truncates_resurrected_copies_and_repairs_rot():
    store = _settled_store()
    store.gc_pass()
    zombie = next(iter(store._gc_index))
    store.replicas[0].repair(zombie, Vote.COMMIT, 99, True)
    # Rot one RETAINED slot on replica 1 so the scrubber has real work.
    store.log_once("p2", "live", Vote.VOTE_YES, writer="p2")
    live = ("p2", "live")
    assert store.replicas[1].corrupt_slot(live)
    store.scrub_pass()
    assert zombie not in store.replicas[0].keys()
    assert store.replicas[1].corrupt_keys() == []
    assert store.scrub_repairs >= 1
    assert store.read_state("p2", "live") == Vote.VOTE_YES


def test_quarantine_refreshes_volume_from_peers():
    store = _settled_store(LifecycleConfig(checksums=True, scrub=True,
                                           quarantine_threshold=3))
    keys = [("p0", f"t{t}") for t in range(3)]
    for k in keys:
        assert store.replicas[2].corrupt_slot(k)
    store.scrub_pass()
    assert store.quarantines == 1
    assert store.replicas[2].corrupt_keys() == []
    for p, t in keys:
        assert store.read_state(p, t) is not None


def _plain(v):
    """A store's answer with the package's classes taken off: a Vote by
    name, a CorruptRecord by its fields."""
    if hasattr(v, "torn"):
        return ("CorruptRecord", v.partition, v.txn, v.torn, v.detail)
    return getattr(v, "name", v)


def _gc_journal(store):
    return [(e.partition, e.txn, e.value, e.decision, e.settled)
            for e in store.gc_log]


def test_anti_resurrection_matches_the_reference():
    """The same zombies planted, scrubbed and state-transferred on both
    packages' threaded stores: the same GC journal, counters, replica
    images and answers."""
    seen = []
    for pkg in (PORT, REFERENCE):
        vote = pkg[2].Vote
        store = _settled_store(pkg=pkg)
        n = store.gc_pass()
        truncated = sorted(store._gc_index)
        for k in truncated[:3]:
            store.replicas[2].repair(k, vote.COMMIT, 99, True)
        store.replicas[0].repair(truncated[-1], vote.ABORT, 99, True)
        store.log_once("p2", "live", vote.VOTE_YES, writer="p2")
        store.replicas[1].corrupt_slot(("p2", "live"))
        repairs = store.scrub_pass()
        store._state_transfer(2, store._membership.replica_ids)
        answers = [(store.read_state(*k).name,
                    store.log_once(*k, vote.COMMIT, writer="n9").name)
                   for k in truncated + [("p2", "live")]]
        seen.append((n, truncated, _gc_journal(store), repairs,
                     store.scrub_repairs, store.quarantines,
                     [sorted(r.keys()) for r in store.replicas], answers))
    assert seen[0] == seen[1]


def test_memorystore_gc_interleaving_invariants():
    """Random op/GC interleavings on the single-volume store: a decided
    slot always answers its decision (before and after truncation), and
    truncation never lets a slot be re-claimed or flipped."""
    for seed in range(10):
        rng = random.Random(seed)
        ms = MemoryStore(lifecycle=LifecycleConfig(checksums=True, gc=True))
        decided = {}
        for step in range(120):
            p = f"p{rng.randrange(3)}"
            t = f"t{rng.randrange(20)}"
            op = rng.random()
            if op < 0.4:
                ms.log_once(p, t, Vote.VOTE_YES, writer=p)
            elif op < 0.7:
                # One decision per TXN id (atomic commit): every slot of a
                # txn terminates the same way, as the protocols guarantee.
                d = Vote.COMMIT if int(t[1:]) % 2 else Vote.ABORT
                got = ms.log(p, t, d, writer=p)
                decided.setdefault((p, t), got)
            elif op < 0.8:
                ms.gc_pass()
            else:
                ms.read_state(p, t)
            for k, want in decided.items():
                assert ms.read_state(*k) == want, (seed, step, k)
        ms.gc_pass()
        for k, want in decided.items():
            assert ms.read_state(*k) == want
            assert ms.log_once(*k, Vote.VOTE_YES, writer="z") == want


@pytest.mark.parametrize("seed", range(4))
def test_memorystore_gc_interleaving_matches_the_reference(seed):
    """One seeded op/GC/rot interleaving on both packages' single-volume
    stores: every answer, the GC journal, the watermarks and the
    lifecycle counters are the reference's."""
    runs = []
    for storage, lcmod, state in (PORT, REFERENCE):
        vote = state.Vote
        rng = random.Random(seed)
        ms = storage.MemoryStore(lifecycle=lcmod.LifecycleConfig(
            checksums=True, gc=True))
        flips = random.Random(seed + 100)
        trace = []
        for _ in range(200):
            p, t = f"p{rng.randrange(3)}", f"t{rng.randrange(20)}"
            op = rng.random()
            if op < 0.35:
                got = ms.log_once(p, t, vote.VOTE_YES, writer=p)
            elif op < 0.65:
                d = vote.COMMIT if int(t[1:]) % 2 else vote.ABORT
                got = ms.log(p, t, d, writer=p)
            elif op < 0.75:
                got = ms.gc_pass()
            elif op < 0.85:
                got = ms.bitflip(flips)
            else:
                got = ms.read_state(p, t)
            trace.append(_plain(got))
        ms.scrub_pass()
        runs.append((trace, _gc_journal(ms), dict(ms.watermarks),
                     ms.watermark_lag(), ms.gc_truncations,
                     ms.corrupt_records, ms.scrub_repairs,
                     {k: v.name for k, v in ms.snapshot().items()}))
    assert runs[0] == runs[1]


if HAS_HYPOTHESIS:
    @given(st.lists(st.tuples(st.integers(0, 2), st.integers(0, 19),
                              st.integers(0, 99)),
                    min_size=1, max_size=200))
    @settings(max_examples=50, deadline=None)
    def test_prop_gc_never_loses_decisions(ops):
        ms = MemoryStore(lifecycle=LifecycleConfig(checksums=True, gc=True))
        decided = {}
        for pi, ti, r in ops:
            p, t = f"p{pi}", f"t{ti}"
            if r < 40:
                ms.log_once(p, t, Vote.VOTE_YES, writer=p)
            elif r < 70:
                d = Vote.COMMIT if ti % 2 else Vote.ABORT
                decided.setdefault((p, t), ms.log(p, t, d, writer=p))
            else:
                ms.gc_pass()
        ms.gc_pass()
        for k, want in decided.items():
            assert ms.read_state(*k) == want
            assert ms.log_once(*k, Vote.VOTE_YES, writer="z") == want
