"""Twin of the parts of ``tests/test_store_api.py`` that no other
``tests/test_torch_*.py`` file holds, on the port's modules
(``repro_torch.core``): the same assertions.

Unified store API: registry names, factory construction, membership
plumbing, and the per-lane adaptive-timeout policy the redesign threads
through ``ProtocolConfig.timeout(kind, lane=...)``.

Where each reference test is held (``commit_core`` is
tests/test_torch_commit_core.py, ``ckpt`` tests/test_torch_ckpt.py):

  test_registered_backends            commit_core::test_store_config_and_
                                      registry_match
  test_unknown_backend_lists_registered
                                      commit_core::test_simulated_and_
                                      unknown_backends_are_refused
  test_is_simulated                   commit_core::test_store_config_and_
                                      registry_match
  test_build_memory_and_control_plane ckpt::test_memory_store_control_plane
  test_build_file_needs_root          here
  test_build_replicated               here (commit_core::test_build_store_
                                      builds_the_same_classes holds only
                                      the class)
  test_simulated_backends_require_sim commit_core::test_simulated_and_
                                      unknown_backends_are_refused and
                                      ::test_simulated_backends_build_the_
                                      reference_classes
  test_batching_wraps_threaded_backends
                                      commit_core::test_build_store_builds_
                                      the_same_classes
  test_make_store_shim_is_gone        here
  test_membership_config_normalizes_and_quorums         here
  test_build_replicated_with_membership                 here
  test_build_replicated_sim_with_membership             here
  test_ewma_stat_matches_legacy_update_law
                                      ckpt::test_ewma_stat_matches_legacy_
                                      update_law
  test_per_lane_timeouts_isolate_the_hot_lane           here
  test_global_ewma_dilution_regression                  here
  test_sim_storage_records_lane_stats_unconditionally   here
  test_lease_keeper_* (six tests)     commit_core, under the same names

The ``*_matches_the_reference`` cases run the same inputs through the JAX
package's modules and compare with ``==``.  These tests import no torch:
the port's commit core is standard library only.
"""
from __future__ import annotations

import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.core import (AZURE_REDIS, AdaptiveTimeouts, FileStore,
                              MembershipConfig, ReplicatedStore, Sim,
                              SimStorage, StoreConfig, Vote, build_store)


# ---------------------------------------------------------------------------
# Factory construction
# ---------------------------------------------------------------------------
def test_build_file_needs_root(tmp_path):
    with pytest.raises(ValueError):
        build_store(StoreConfig(backend="file"))
    store = build_store(StoreConfig(backend="file", root=str(tmp_path)))
    assert isinstance(store, FileStore)
    assert store.log_once("h0", "t1", Vote.VOTE_YES, writer="h0") \
        == Vote.VOTE_YES


def test_build_replicated():
    store = build_store(StoreConfig(backend="replicated", replication=5,
                                    seed=11))
    assert isinstance(store, ReplicatedStore) and store.n == 5


# ---------------------------------------------------------------------------
# Membership plumbing (make_store shim removed — factory is the only door)
# ---------------------------------------------------------------------------
def test_make_store_shim_is_gone():
    import repro_torch.core
    import repro_torch.core.stores
    assert not hasattr(repro_torch.core, "make_store")
    assert not hasattr(repro_torch.core.stores, "make_store")


def test_membership_config_normalizes_and_quorums():
    m = MembershipConfig(1, (2, 0, 1, 1))
    assert m.replica_ids == (0, 1, 2)
    assert m.n == 3 and m.quorum == 2
    assert m.quorum_of([0, 1]) and not m.quorum_of([2])
    # quorum_of counts only THIS config's members.
    assert not m.quorum_of([7, 8, 9])


def test_build_replicated_with_membership():
    store = build_store(StoreConfig(backend="replicated",
                                    membership=(0, 2, 4)))
    assert store.n == 3 and store.quorum == 2
    assert len(store.replicas) == 5       # table sized for the id space
    assert store.membership.replica_ids == (0, 2, 4)


def test_build_replicated_sim_with_membership():
    sim = Sim()
    store = build_store(
        StoreConfig(backend="replicated-sim", model=AZURE_REDIS,
                    replication=5, membership=(0, 1, 2)), sim=sim)
    assert store.n == 3 and store.quorum == 2
    assert store.member_ids == [0, 1, 2]


@pytest.mark.parametrize("config_id,ids", [
    (1, (2, 0, 1, 1)), (3, (0, 2, 4)), (2, (5,)), (7, (0, 1, 2, 3, 4, 5, 6))])
def test_membership_matches_the_reference(config_id, ids):
    """Normalized ids, size, quorum and every quorum_of answer over the
    subsets of 0-7 are the reference's."""
    t = MembershipConfig(config_id, ids)
    j = jcore.MembershipConfig(config_id, ids)
    assert (t.config_id, t.replica_ids, t.n, t.quorum) \
        == (j.config_id, j.replica_ids, j.n, j.quorum)
    for mask in range(256):
        sub = [i for i in range(8) if mask >> i & 1]
        assert t.quorum_of(sub) == j.quorum_of(sub), sub


@pytest.mark.parametrize("backend,kw", [
    ("replicated", dict(membership=(0, 2, 4))),
    ("replicated", dict(replication=5, seed=11)),
    ("replicated-sim", dict(model="AZURE_REDIS", replication=5,
                            membership=(0, 1, 2))),
    ("replicated-sim", dict(model="AZURE_REDIS", replication=4,
                            membership=(1, 2, 3)))])
def test_replicated_builds_match_the_reference(backend, kw):
    """Membership threaded through the factory: the same member ids,
    quorum and replica table on both packages' stores."""
    seen = []
    for core in (tcore, jcore):
        args = dict(kw)
        if "model" in args:
            args["model"] = getattr(core, args["model"])
        sim = core.Sim() if backend == "replicated-sim" else None
        store = core.build_store(core.StoreConfig(backend=backend, **args),
                                 **({"sim": sim} if sim else {}))
        members = (list(store.membership.replica_ids)
                   if backend == "replicated" else list(store.member_ids))
        seen.append((type(store).__name__, store.n, store.quorum, members,
                     len(store.replicas)))
    assert seen[0] == seen[1]


# ---------------------------------------------------------------------------
# Per-lane EWMAs / AdaptiveTimeouts (the global-dilution fix)
# ---------------------------------------------------------------------------
class _FakeLaneStorage:
    """Storage stats double: one saturated lane, quiet global aggregate."""

    write_lat_ewma = 1.0
    write_lat_dev = 0.1

    def lane_write_latency(self, lane):
        return (400.0, 40.0) if lane == "hot" else None


def test_per_lane_timeouts_isolate_the_hot_lane():
    pol = AdaptiveTimeouts(_FakeLaneStorage(), jitter=0.0, per_lane=True)
    base = 25.0
    # Hot lane: raised by ITS EWMA (capped at 64x base).
    hot = pol.timeout_ms("vote", base, lane="hot")
    assert hot == pytest.approx(min(64.0 * base, 4.0 * 400.0 + 8.0 * 40.0))
    # Never-observed lane: static floor, NOT the global aggregate and NOT
    # the hot lane's congestion.
    assert pol.timeout_ms("vote", base, lane="cold") == base
    # No lane named: the service-global EWMA path, unchanged.
    assert pol.timeout_ms("vote", base) == base  # 4*1+8*0.1 < base floor


def test_global_ewma_dilution_regression():
    """The bug the per-lane policy fixes: under zipf skew one hot lane's
    queueing drowns in the many idle lanes' fast writes, so the GLOBAL
    policy under-raises the hot lane's deadline.  Per-lane must raise the
    hot lane's timeout strictly above the global policy's while keeping
    cold lanes at the static floor."""
    sim = Sim()
    storage = SimStorage(sim, AZURE_REDIS, seed=0)
    hot, cold = "p0", "p1"
    # 1 slow hot write among many fast cold writes (zipf-ish mix) — drive
    # the mixin's bookkeeping directly; stats are recorded per-lane
    # unconditionally.
    storage._note_write_latency(500.0, lane=hot)
    for _ in range(50):
        storage._note_write_latency(1.0, lane=cold)
    base = 25.0
    global_pol = AdaptiveTimeouts(storage, jitter=0.0)
    lane_pol = AdaptiveTimeouts(storage, jitter=0.0, per_lane=True)
    # Global EWMA was diluted toward the fast lane...
    assert global_pol.timeout_ms("vote", base, lane=hot) < \
        lane_pol.timeout_ms("vote", base, lane=hot)
    # ...per-lane keeps the hot signal hot (hits the 64x cap here)...
    assert lane_pol.timeout_ms("vote", base, lane=hot) == \
        pytest.approx(64.0 * base)
    # ...and the cold lane stays at its own (floor) deadline.
    assert lane_pol.timeout_ms("vote", base, lane=cold) == base


def test_sim_storage_records_lane_stats_unconditionally():
    sim = Sim()
    storage = SimStorage(sim, AZURE_REDIS, seed=0)
    done = {}

    def proc():
        v = yield storage.log_once("pA", "t1", Vote.VOTE_YES, writer="pA")
        done["v"] = v

    sim.process(proc())
    sim.run(until=10_000.0)
    assert done["v"] == Vote.VOTE_YES
    assert storage.lane_write_latency("pA") is not None
    assert storage.lane_write_latency("pB") is None


def _lane_timeouts(core, jitter, seed):
    """One skewed write mix on a package's SimStorage, then each policy's
    deadline for every lane and kind, and the lanes' EWMA stats."""
    sim = core.Sim()
    storage = core.SimStorage(sim, core.AZURE_REDIS, seed=0)
    lats = [500.0, 3.0, 1.0, 40.0, 1.0, 0.5, 220.0, 1.0]
    for i in range(60):
        storage._note_write_latency(lats[i % len(lats)] * (1 + i % 3),
                                    lane=f"p{i % 4}")
    pols = [core.AdaptiveTimeouts(storage, jitter=jitter, seed=seed,
                                  per_lane=per_lane)
            for per_lane in (False, True)]
    out = [(storage.write_lat_ewma, storage.write_lat_dev)]
    for lane in ("p0", "p1", "p2", "p3", "p9", None):
        out.append(storage.lane_write_latency(lane) if lane else None)
        for pol in pols:
            for kind in ("vote", "decision", "votereq", "coop_retry"):
                out.append(pol.timeout_ms(kind, 25.0, lane=lane))
    return out


@pytest.mark.parametrize("jitter,seed", [(0.0, 0), (0.1, 3)])
def test_lane_timeouts_match_the_reference(jitter, seed):
    """The same write mix on both packages' sim services: the global and
    per-lane EWMAs and every deadline of both policies (jittered from the
    same seed) are the reference's."""
    assert _lane_timeouts(tcore, jitter, seed) \
        == _lane_timeouts(jcore, jitter, seed)


def test_sim_lane_stats_match_the_reference():
    """A few seeded writes through both packages' sim services: the
    answers, their times and the per-lane stats agree."""
    seen = []
    for core in (tcore, jcore):
        sim = core.Sim()
        storage = core.SimStorage(sim, core.AZURE_REDIS, seed=4)
        got = []

        def proc(p, t, core=core, sim=sim, storage=storage, got=got):
            v = yield storage.log_once(p, t, core.Vote.VOTE_YES, writer=p)
            w = yield storage.log(p, t, core.Vote.COMMIT, writer=p)
            got.append((p, t, v.name, w.name, sim.now))

        for i in range(12):
            sim.process(proc(f"p{i % 3}", f"t{i}"))
        sim.run(until=10_000.0)
        seen.append((sorted(got),
                     [storage.lane_write_latency(f"p{i}") for i in range(4)],
                     storage.write_lat_ewma, storage.write_lat_dev))
    assert seen[0] == seen[1]
