"""The atomicity scan of the commit cores under chaos, on either package.

Runs ``benchmarks/chaos.run_one``'s cell (4 nodes x 2 closed-loop
clients, YCSB, fresh retry ids, the history checker on; checksums, GC and
scrub armed under the "rot" mix) over a grid of (protocol, mix, R, seed)
at horizon 200 sim ms, on the port (``repro_torch``, through
``chaos_run_one``, the port's copy of that function) or the reference
(``repro``, through ``benchmarks/chaos.run_one`` itself), and reports
every cell with a checker violation or a failed client-acknowledgement
check.

The client-acknowledgement check (``ack_violations``) flags a coordinator
whose recorded outcome, the answer its client got, differs from some
node's decision of the same txn.  The history checker misses that case
when the coordinator's own node decided the other way first: it reads a
node's live decision before its recorded outcome.

Run from the repo root (6 processes; about 5 minutes for both packages
on 6 CPU cores):

    PYTHONPATH=src python tests/twopc_scan.py --package both --out scan.json

``tests/test_torch_gc_safety.py`` imports ``chaos_run_one`` and
``run_cell`` from here, holds ``chaos_run_one`` to the reference's
``run_one`` with ``==``, and its slow test runs ``GRID`` on the port.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import multiprocessing
import os
import sys
import time
from typing import Dict, List, Optional, Tuple
from unittest import mock

HORIZON_MS = 200.0
# The keys a repro bundle's config carries (benchmarks/chaos.CONFIG_KEYS).
CONFIG_KEYS = ("protocol", "n_nodes", "threads_per_node", "horizon_ms",
               "seed", "replication", "retry_fresh_ids", "lifecycle")
# The "rot" mix arms durable-state faults, so the cell arms checksums + GC
# + scrub for it (benchmarks/chaos.LIFECYCLE_MIXES / LIFECYCLE_CFG).
LIFECYCLE_MIXES = ("rot",)
LIFECYCLE_CFG = dict(checksums=True, gc=True, scrub=True,
                     gc_interval_ms=25.0, scrub_interval_ms=40.0)
OTHER_MIXES = ("messages", "partition", "crash", "torn", "skew", "full")
# (protocol, mix, R) -> seeds.
GRID: Dict[Tuple[str, str, int], range] = {
    ("2pc", "rot", 1): range(1000),
    ("2pc", "rot", 3): range(300),
    **{("2pc", mix, r): range(100) for mix in OTHER_MIXES for r in (1, 3)},
    ("cornus", "rot", 1): range(300),
    ("cornus", "rot", 3): range(300),
}
PACKAGES = {"port": "repro_torch", "reference": "repro"}


def chaos_run_one(proto: str, mix: str, replication: int, seed: int,
                  horizon_ms: float):
    """The port's copy of ``benchmarks/chaos.run_one`` (which belongs to
    the reference): one chaotic cell on the port; generate the schedule,
    run, return (res, schedule, bundle config)."""
    from repro_torch.core import AZURE_REDIS, FaultSchedule
    from repro_torch.txn import BenchConfig, YCSBWorkload, run_bench

    nodes = [f"n{i}" for i in range(4)]
    sched = FaultSchedule.generate(seed, nodes, horizon_ms,
                                   replication if replication > 1 else 0,
                                   mix)
    cfg = BenchConfig(protocol=proto, n_nodes=4, threads_per_node=2,
                      horizon_ms=horizon_ms, seed=seed,
                      replication=replication, retry_fresh_ids=True,
                      chaos=sched, record_history=True,
                      lifecycle=(dict(LIFECYCLE_CFG)
                                 if mix in LIFECYCLE_MIXES else None))
    res = run_bench(lambda ns, s: YCSBWorkload(ns, seed=s), AZURE_REDIS, cfg)
    config = {k: getattr(cfg, k) for k in CONFIG_KEYS}
    return res, sched, config


def ack_violations(ctx) -> List[str]:
    """Every txn whose coordinator's recorded outcome (what its client
    was told) differs from a node's decision, live or recovered.  A
    read-only participant concludes COMMIT without seeing the decision
    (paper §3.6), so, as in the history checker, it is not counted."""
    by_txn: Dict[str, List[Tuple[str, str]]] = {}
    for (node, txn), st in ctx.local.items():
        d = getattr(st.get("decision"), "value", None)
        if d in ("COMMIT", "ABORT"):
            by_txn.setdefault(txn, []).append((node, d))
    for (txn, node), out in ctx.outcomes.items():
        d = getattr(out.decision, "value", None)
        if d in ("COMMIT", "ABORT"):
            by_txn.setdefault(txn, []).append((node, d))
    found = []
    for (txn, node), out in sorted(ctx.outcomes.items()):
        spec = ctx.specs.get(txn)
        told = getattr(out.decision, "value", None)
        if spec is None or node != spec.coordinator \
                or told not in ("COMMIT", "ABORT"):
            continue
        other = sorted({(n, d) for n, d in by_txn.get(txn, ())
                        if d != told
                        and (n.split(":")[0] == spec.coordinator
                             or n.split(":")[0] not in spec.read_only)})
        if other:
            found.append(f"[ack] txn={txn}: client told {told} but "
                         f"{other} decided otherwise")
    return found


# The port's 2PC rules that part from the reference, counted per run by
# ``rule_spies`` each time one acts where the reference would not have.
RULES = (
    "unknown_committing",   # a coordinator forcing its commit record
    "unknown_voting",       # a node forcing its YES vote
    "presumed_from_log",    # a restarted coordinator's awaited presumed abort
    "vote_abort_presumed",  # a node that presumed abort votes ABORT
    "coordinator_abort_presumed",  # ... or, as coordinator, decides ABORT
    "recover_from_log",     # recover() took its slot's other decision
    "replica_decision",     # a replicated plain log answered another value
)


def rule_spies(counts: Dict[str, int], seen: dict):
    """Patches of the port's commit core that count ``RULES`` as they act,
    observing only: the run is the same with or without them.  Each count
    is read off the branch the code itself takes: the decision handler
    asks ``_forcing`` only where the reference presumes abort, and calls
    ``_presume_from_log`` only for a stale commit record."""
    root = PACKAGES["port"]
    twopc = importlib.import_module(
        root + ".core.protocols.twopc").TwoPCProtocol
    storage = importlib.import_module(root + ".core.storage")
    forcing, presume, send = (twopc._forcing, twopc._presume_from_log,
                              twopc.send)
    log_vote, log_decision = twopc.log_vote, twopc.log_decision
    recover, resolve = twopc.recover, twopc.recovery_resolve
    answered = storage.ReplicatedSimStorage._answered_decision
    # The mark ``_forcing`` last returned: the handler's "unknown" reply,
    # which follows at once, is then sent on its behalf.
    held = {"mark": None}

    def spy_forcing(st, ep):
        held["mark"] = forcing(st, ep)
        if held["mark"] is not None:
            counts["unknown_" + held["mark"]] += 1
        return held["mark"]

    def spy_send(self, src, dst, txn, kind, *args, **kwargs):
        if held["mark"] == "voting" and kind.startswith("dec-resp:"):
            seen.setdefault("voting_askers", set()).add((txn, dst))
        held["mark"] = None
        return send(self, src, dst, txn, kind, *args, **kwargs)

    def spy_presume(self, server, spec, ep, reply):
        counts["presumed_from_log"] += 1
        return (yield from presume(self, server, spec, ep, reply))

    def spy_log_vote(self, spec, me):
        counts["vote_abort_presumed"] += self._presumed_abort(spec, me)
        return (yield from log_vote(self, spec, me))

    def spy_log_decision(self, spec, me, decision):
        counts["coordinator_abort_presumed"] += (
            decision.value == "COMMIT" and self._presumed_abort(spec, me))
        return (yield from log_decision(self, spec, me, decision))

    resolved = {}

    def spy_resolve(self, spec, me, out, state):
        d = yield from resolve(self, spec, me, out, state)
        resolved[(spec.txn_id, me)] = d
        return d

    def spy_recover(self, spec, me):
        out = yield from recover(self, spec, me)
        d = resolved.pop((spec.txn_id, me), None)
        counts["recover_from_log"] += (d is not None
                                       and d != out.decision)
        return out

    def spy_answered(self, state, answers):
        got = answered(self, state, answers)
        counts["replica_decision"] += got != state
        return got

    return [mock.patch.object(twopc, "_forcing", staticmethod(spy_forcing)),
            mock.patch.object(twopc, "send", spy_send),
            mock.patch.object(twopc, "_presume_from_log", spy_presume),
            mock.patch.object(twopc, "log_vote", spy_log_vote),
            mock.patch.object(twopc, "log_decision", spy_log_decision),
            mock.patch.object(twopc, "recovery_resolve", spy_resolve),
            mock.patch.object(twopc, "recover", spy_recover),
            mock.patch.object(storage.ReplicatedSimStorage,
                              "_answered_decision", spy_answered)]


def run_cell(package: str, proto: str, mix: str, replication: int,
             seed: int, horizon_ms: float = HORIZON_MS,
             rules: Optional[Dict[str, int]] = None):
    """One chaos cell on ``package`` ("port": ``chaos_run_one``;
    "reference": ``benchmarks/chaos.run_one``): (BenchResult, the
    client-acknowledgement violations, the number of (txn, node) pairs
    whose cooperative termination blocked).  On the port, ``rules`` (a
    dict) receives the count of each of ``RULES``, and
    ``blocked_on_voting``: the blocked (txn, node) pairs that a node
    forcing its YES vote had answered "unknown"."""
    executor = importlib.import_module(PACKAGES[package] + ".txn.executor")
    run_one = (chaos_run_one if package == "port"
               else importlib.import_module("benchmarks.chaos").run_one)
    seen = {}
    check = executor.check_history

    def spy(history, ctx, **kw):
        seen["ctx"] = ctx
        return check(history, ctx, **kw)

    patches = [mock.patch.object(executor, "check_history", spy)]
    if rules is not None:
        rules.update({k: 0 for k in RULES})
        patches += rule_spies(rules, seen)
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        res, _sched, _config = run_one(proto, mix, replication, seed,
                                       horizon_ms)
    if rules is not None:
        rules["blocked_on_voting"] = len(
            seen.get("voting_askers", set()) & set(seen["ctx"].blocked))
    return res, ack_violations(seen["ctx"]), len(seen["ctx"].blocked)


def _row(job) -> dict:
    package, proto, mix, replication, seed, count_rules = job
    rules = {} if count_rules and package == "port" else None
    res, ack, blocked = run_cell(package, proto, mix, replication, seed,
                                 rules=rules)
    return dict(package=package, proto=proto, mix=mix, r=replication,
                seed=seed, violations=res.violations, commits=res.commits,
                gc_truncations=res.gc_truncations, ack=len(ack),
                blocked=blocked, rules=rules,
                avg_latency_ms=res.avg_latency_ms,
                detail=(res.violation_details[:2] + ack[:2]))


def summarize(rows: List[dict]) -> Dict[str, dict]:
    """(package, protocol, mix, R) -> cells run, violating seeds, and
    seeds whose client-acknowledgement check failed."""
    out: Dict[str, dict] = {}
    for r in rows:
        key = f"{r['package']}/{r['proto']}/{r['mix']}/r{r['r']}"
        s = out.setdefault(key, dict(cells=0, violating=[], ack=[],
                                     commits=0))
        s["cells"] += 1
        s["commits"] += r["commits"]
        if r["violations"]:
            s["violating"].append(r["seed"])
        if r["ack"]:
            s["ack"].append(r["seed"])
    return out


def _key(r: dict) -> Tuple[str, str, int, int]:
    return (r["proto"], r["mix"], r["r"], r["seed"])


def compare(rows: List[dict]) -> Dict[str, dict]:
    """(protocol, mix, R) -> how the port's cells part from the
    reference's: the cells that moved (commits, violations, GC
    truncations or average latency), the moved cells in which each of
    ``RULES`` acted, those in which none did, the cells whose commits
    fell below 90% of the reference's (with both packages' blocked
    (txn, node) pairs) and the count that rose above 1/0.9 of it."""
    ref = {_key(r): r for r in rows if r["package"] == "reference"}
    out: Dict[str, dict] = {}
    fields = ("commits", "violations", "gc_truncations", "avg_latency_ms")
    for r in rows:
        o = ref.get(_key(r))
        if r["package"] != "port" or o is None:
            continue
        s = out.setdefault(f"{r['proto']}/{r['mix']}/r{r['r']}", dict(
            cells=0, moved=0, by_rule={}, unexplained=[], down=[], up=0,
            commits=0, ref_commits=0))
        s["cells"] += 1
        s["commits"] += r["commits"]
        s["ref_commits"] += o["commits"]
        if all(r[f] == o[f] for f in fields):
            continue
        s["moved"] += 1
        acted = sorted(k for k in RULES if (r["rules"] or {}).get(k))
        for k in acted:
            s["by_rule"][k] = s["by_rule"].get(k, 0) + 1
        if not acted:
            s["unexplained"].append(r["seed"])
        if r["commits"] < 0.9 * o["commits"]:
            s["down"].append(dict(seed=r["seed"], commits=r["commits"],
                                  ref_commits=o["commits"],
                                  blocked=r["blocked"],
                                  ref_blocked=o["blocked"], rules=acted,
                                  blocked_on_voting=(r["rules"] or {}).get(
                                      "blocked_on_voting", 0)))
        elif r["commits"] * 0.9 > o["commits"]:
            s["up"] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("port", "reference", "both"),
                    default="port")
    ap.add_argument("--proto", default=None,
                    help="only this protocol (default: every cell of GRID)")
    ap.add_argument("--mix", default=None, help="only this fault mix")
    ap.add_argument("-j", "--jobs", type=int, default=6)
    ap.add_argument("--out", default=None,
                    help="write every cell's row and the summary as JSON")
    ap.add_argument("--no-rules", action="store_true",
                    help="do not count the port's 2PC rules (for a "
                         "checkout of the port that predates them)")
    args = ap.parse_args(argv)
    pkgs = ("port", "reference") if args.package == "both" \
        else (args.package,)
    jobs = [(pkg, proto, mix, r, s, not args.no_rules)
            for pkg in pkgs
            for (proto, mix, r), seeds in GRID.items()
            if (args.proto in (None, proto)) and (args.mix in (None, mix))
            for s in seeds]
    t0 = time.perf_counter()
    with multiprocessing.get_context("fork").Pool(args.jobs) as pool:
        rows = pool.map(_row, jobs, chunksize=4)
    wall = time.perf_counter() - t0
    summary = summarize(rows)
    for key, s in sorted(summary.items()):
        print(f"{key}: {s['cells']} cells, {s['commits']} commits, "
              f"violating {len(s['violating'])} {s['violating']}, "
              f"ack {len(s['ack'])} {s['ack']}")
    moved = compare(rows)
    for key, s in sorted(moved.items()):
        print(f"port vs reference {key}: {s['moved']} of {s['cells']} "
              f"cells moved; commits {s['commits']} vs {s['ref_commits']}; "
              f"rules acting in moved cells {s['by_rule']}; unexplained "
              f"{s['unexplained']}; up >10% {s['up']}; down >10% "
              f"{len(s['down'])}")
        for d in s["down"]:
            print(f"    down: seed {d['seed']} commits {d['commits']} vs "
                  f"{d['ref_commits']}, blocked {d['blocked']} vs "
                  f"{d['ref_blocked']} ({d['blocked_on_voting']} after a "
                  f"voting node's \"unknown\"), rules {d['rules']}")
    print(f"{len(rows)} cells in {wall:.1f} s on {args.jobs} processes")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(summary=summary, compare=moved, rows=rows,
                           wall_s=wall), f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    # After PYTHONPATH, so that another checkout's src can be scanned;
    # the repo root holds the reference's ``benchmarks``.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path += [os.path.join(root, "src"), root]
    sys.exit(main())
