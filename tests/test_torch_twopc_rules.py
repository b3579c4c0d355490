"""The port's 2PC rules that part from the reference, each in the one
seeded scenario that shows it, run on both packages' commit cores
(``repro_torch.core`` and ``repro.core``).

The reference decides both ways (or answers both terminal values from one
slot) in each scenario; the port does not:

  * a node that presumed abort for an attempt before that attempt's vote
    request arrived votes ABORT in it (as a participant) or decides ABORT
    (as the coordinator collecting votes);
  * a restarted coordinator asked about a txn whose commit record its dead
    incarnation was forcing presumes abort only through its own slot, and
    decides what the slot answers;
  * ``recover`` decides what its decision write answers;
  * a plain ``log`` on the replicated sim store answers the decision a
    quorum of the slot's replicas holds.

The scan over chaos cells is ``tests/twopc_scan.py``;
``tests/test_torch_gc_safety.py`` holds its regression cells.  These
tests import no torch: the port's commit core is standard library only.
"""
from __future__ import annotations

import importlib

import pytest

PACKAGES = ("repro_torch", "repro")


def _core(pkg: str):
    return importlib.import_module(pkg + ".core")


def _ask(pkg, cluster, server, txn, asker, spec):
    """A decision request from ``asker`` reaching ``server`` after one
    link delay (the port's handler also takes the asker's attempt)."""
    serve = cluster.protocol._serve_decision_request
    if pkg == "repro_torch":
        serve(server, txn, asker, 1, spec)
    else:
        serve(server, txn, asker, 1)


def _decisions(cluster, txn="t"):
    return {node: getattr(st["decision"], "value", None)
            for (node, t), st in sorted(cluster.ctx.local.items())
            if t == txn}


def _violations(pkg, cluster, storage):
    history = importlib.import_module(pkg + ".core.history")
    return [str(v) for v in history.check_run(cluster.ctx, storage)]


def _cluster(pkg, nodes=("n0", "n1", "n2"), lifecycle=None, seed=0):
    core = _core(pkg)
    sim = core.Sim()
    storage = core.SimStorage(sim, core.AZURE_REDIS, seed=seed,
                              lifecycle=lifecycle)
    cluster = core.Cluster(sim, storage, list(nodes),
                           core.ProtocolConfig(protocol="2pc"))
    return core, sim, storage, cluster


def _spec(core, coordinator="n0", participants=("n1", "n2")):
    return core.TxnSpec(txn_id="t", coordinator=coordinator,
                        participants=list(participants))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_participant_that_presumed_abort_votes_abort(pkg):
    """n1 asks n2 before n2's vote request arrives: n2 presumes abort and
    answers ABORT.  The reference's n2 then votes YES and the coordinator
    commits over n2's ABORT; the port's n2 votes ABORT."""
    core, sim, storage, cluster = _cluster(pkg)
    spec = _spec(core)
    _ask(pkg, cluster, "n2", "t", "n1", spec)    # lands first: FIFO tie
    done = cluster.run_txn(spec)
    sim.run(until=1000.0)
    got = _decisions(cluster)
    if pkg == "repro":
        assert done.value.decision == core.Decision.COMMIT
        assert got == {"n0": "COMMIT", "n1": "COMMIT", "n2": "ABORT"}
        assert any(v.startswith("[AC1]")
                   for v in _violations(pkg, cluster, storage))
    else:
        assert done.value.decision == core.Decision.ABORT
        assert got == {"n0": "ABORT", "n1": "ABORT", "n2": "ABORT"}
        assert _violations(pkg, cluster, storage) == []


@pytest.mark.parametrize("pkg", PACKAGES)
def test_coordinator_that_presumed_abort_decides_abort(pkg):
    """A participant's request reaches the coordinator while it collects
    votes: it presumes abort and answers ABORT.  The reference's
    coordinator still commits and tells its client COMMIT; the port's
    decides ABORT."""
    core, sim, storage, cluster = _cluster(pkg)
    spec = _spec(core)
    _ask(pkg, cluster, "n0", "t", "n1", spec)
    done = cluster.run_txn(spec)
    sim.run(until=1000.0)
    got = _decisions(cluster)
    if pkg == "repro":
        assert done.value.decision == core.Decision.COMMIT
        assert got == {"n0": "ABORT", "n1": "COMMIT", "n2": "COMMIT"}
        assert _violations(pkg, cluster, storage)
    else:
        assert done.value.decision == core.Decision.ABORT
        assert got == {"n0": "ABORT", "n1": "ABORT", "n2": "ABORT"}
        assert _violations(pkg, cluster, storage) == []


def _commit_landed_then_restart(pkg, lifecycle=None):
    """The coordinator n0 (no partition of its own) crashes just after
    issuing its commit record, which lands; it restarts 50 sim ms later.
    Returns (core, sim, storage, cluster, spec, restart time, the
    coordinator's done event)."""
    core, sim, storage, cluster = _cluster(pkg, lifecycle=lifecycle)
    spec = _spec(core)
    done = cluster.run_txn(spec)
    # The decision point, both votes in, read off a fault-free twin.
    _, sim2, _, twin = _cluster(pkg, lifecycle=lifecycle)
    twin_done = twin.run_txn(_spec(core))
    sim2.run(until=1000.0)
    t_dec = twin_done.value.prepare_ms
    t_restart = t_dec + 50.0
    cluster.schedule_crash_restart("n0", t_dec + 0.01, t_restart)
    return core, sim, storage, cluster, spec, t_restart, done


@pytest.mark.parametrize("pkg", PACKAGES)
def test_restarted_coordinator_presumes_abort_through_its_slot(pkg):
    """After the restart, n1's request reaches n0 before its recovery has
    read the record.  The reference's n0 presumes abort and answers ABORT,
    then recovers COMMIT; the port's presumes abort through its slot,
    which answers COMMIT, and answers that."""
    core, sim, storage, cluster, spec, t_restart, _ = \
        _commit_landed_then_restart(pkg)
    sim._schedule(t_restart, lambda: _ask(pkg, cluster, "n0", "t", "n1",
                                          spec))
    sim.run(until=1000.0)
    assert storage.snapshot()[("n0", "t")] == core.Vote.COMMIT
    live = _decisions(cluster)["n0"]
    recovered = cluster.ctx.outcomes[("t", "n0:recovery")].decision.value
    if pkg == "repro":
        assert (live, recovered) == ("ABORT", "COMMIT")
        assert _violations(pkg, cluster, storage)
    else:
        assert (live, recovered) == ("COMMIT", "COMMIT")
        assert _violations(pkg, cluster, storage) == []


@pytest.mark.parametrize("pkg", PACKAGES)
def test_recover_decides_what_its_slot_answers(pkg):
    """A restarted coordinator that is also a participant reads its
    VOTE-YES, presumes abort, and writes ABORT; its dead incarnation's
    COMMIT record lands between the read and the write.  The reference
    recovers ABORT over a COMMIT slot; the port takes the slot's COMMIT."""
    core, sim, storage, cluster = _cluster(pkg)
    spec = _spec(core, participants=("n0", "n1"))
    cluster.ctx.specs["t"] = spec
    storage.store.log("n0", "t", core.Vote.VOTE_YES, "n0")
    cluster.recover_txn(spec, "n0")           # its read applies first
    storage.log("n0", "t", core.Vote.COMMIT, writer="n0")
    sim.run(until=1000.0)
    assert storage.snapshot()[("n0", "t")] == core.Vote.COMMIT
    recovered = cluster.ctx.outcomes[("t", "n0:recovery")].decision.value
    assert recovered == ("ABORT" if pkg == "repro" else "COMMIT")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_replicated_plain_log_keeps_the_first_decision(pkg):
    """A plain ``log`` of ABORT on an R = 3 slot that holds COMMIT: every
    replica refuses the flip; the reference answers ABORT anyway, the
    port answers the slot's COMMIT."""
    core = _core(pkg)
    sim = core.Sim()
    storage = core.ReplicatedSimStorage(sim, core.AZURE_REDIS, n_replicas=3)
    first = storage.log("p", "t", core.Vote.COMMIT, writer="p")
    sim.run(until=100.0)
    second = storage.log("p", "t", core.Vote.ABORT, writer="p")
    sim.run(until=200.0)
    read = storage.read_state("p", "t", writer="p")
    sim.run(until=300.0)
    assert (first.value, read.value) == (core.Vote.COMMIT, core.Vote.COMMIT)
    assert second.value == (core.Vote.ABORT if pkg == "repro"
                            else core.Vote.COMMIT)


@pytest.mark.parametrize("batched", [False, True],
                         ids=["quorum-write", "batched-flush"])
@pytest.mark.parametrize("pkg", PACKAGES)
def test_replicated_plain_log_answers_what_a_quorum_holds(pkg, batched):
    """A COMMIT that reached one replica only (its writes to the others
    still in flight), with replica 2 down: a plain ``log`` of ABORT lands
    on replica 1 and replica 0 refuses the flip.  Both packages answer
    ABORT, the port from a read of the slot.  Then the COMMIT's writes
    land: the reference answers COMMIT, and its slot now reads COMMIT
    after it told the ABORT writer ABORT; the port answers ABORT and its
    slot stays ABORT.  Alike through ``_quorum_write`` and through the
    group-commit lane's batched flush."""
    core = _core(pkg)
    sim = core.Sim()
    storage = core.ReplicatedSimStorage(
        sim, core.AZURE_REDIS, n_replicas=3,
        batch=core.BatchConfig(serial=True) if batched else None)
    storage.replicas[0].write(("p", "t"), core.Vote.COMMIT, 1, "p")
    storage.fail_replica(2)
    abort = storage.log("p", "t", core.Vote.ABORT, writer="p")
    sim.run(until=100.0)
    commit = storage.log("p", "t", core.Vote.COMMIT, writer="p")
    sim.run(until=200.0)
    read = storage.read_state("p", "t", writer="p")
    sim.run(until=300.0)
    got = (abort.value, commit.value, read.value)
    A, C = core.Vote.ABORT, core.Vote.COMMIT
    assert got == ((A, C, C) if pkg == "repro" else (A, A, A))
