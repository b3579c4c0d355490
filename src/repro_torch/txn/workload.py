"""Workload generators: YCSB (§5.1.3) and TPC-C (§5.4).

The port's copy of ``repro/txn/workload.py`` (the standard library only; the
port imports nothing of the JAX package).

YCSB: one table partitioned round-robin; each transaction accesses 16 tuples,
50/50 read/write by default, keys drawn zipfian(θ) — θ=0 is uniform.

TPC-C: 50/50 NewOrder/Payment over W warehouses spread across nodes; fewer
warehouses ⇒ hotter warehouse/district rows ⇒ more NO-WAIT aborts.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable, List, Sequence, Tuple


# One logical data access: (partition_node, key, is_write).
Access = Tuple[str, str, bool]


def zipf_sampler(n: int, theta: float, rng: random.Random) -> Callable[[], int]:
    """Gray et al. zipfian over [0, n); theta=0 degenerates to uniform."""
    if theta <= 1e-9:
        return lambda: rng.randrange(n)
    # Precompute zeta constants once (n is small enough per partition).
    zetan = sum(1.0 / (i ** theta) for i in range(1, n + 1))
    zeta2 = sum(1.0 / (i ** theta) for i in range(1, 3))
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - (2.0 / n) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)

    def sample() -> int:
        u = rng.random()
        uz = u * zetan
        if uz < 1.0:
            return 0
        if uz < 1.0 + 0.5 ** theta:
            return 1
        return int(n * (eta * u - eta + 1.0) ** alpha)

    return sample


@dataclass
class Txn:
    txn_id: str
    coordinator: str
    accesses: List[Access]

    @property
    def participants(self) -> List[str]:
        seen: List[str] = []
        for node, _, _ in self.accesses:
            if node not in seen:
                seen.append(node)
        return seen

    @property
    def read_only_parts(self) -> frozenset:
        writes = {n for n, _, w in self.accesses if w}
        return frozenset(p for p in self.participants if p not in writes)

    @property
    def is_distributed(self) -> bool:
        return len(self.participants) > 1


class YCSBWorkload:
    def __init__(self, nodes: Sequence[str], theta: float = 0.0,
                 accesses_per_txn: int = 16, read_ratio: float = 0.5,
                 keys_per_partition: int = 10_000, seed: int = 0,
                 partition_theta: float = 0.0):
        self.nodes = list(nodes)
        self.theta = theta
        self.n_access = accesses_per_txn
        self.read_ratio = read_ratio
        self.rng = random.Random(seed)
        self.keys = keys_per_partition
        self._zipf = zipf_sampler(keys_per_partition, theta, self.rng)
        # Hot-partition skew (group-commit contention benches): partitions
        # drawn zipfian(partition_theta) instead of uniformly — θ=0 keeps
        # the original uniform draw, bit-identically.
        self.partition_theta = partition_theta
        self._pzipf = zipf_sampler(len(self.nodes), partition_theta, self.rng)
        self._seq = 0

    def next_txn(self, coordinator: str) -> Txn:
        self._seq += 1
        accesses: List[Access] = []
        used = set()
        while len(accesses) < self.n_access:
            node = self.nodes[self._pzipf()]
            key = f"k{self._zipf()}"
            if (node, key) in used:
                continue
            used.add((node, key))
            is_write = self.rng.random() >= self.read_ratio
            accesses.append((node, key, is_write))
        return Txn(f"ycsb-{coordinator}-{self._seq}", coordinator, accesses)


class GeoYCSBWorkload(YCSBWorkload):
    """Geo-distributed YCSB (extended §6): coordinators run in a *home*
    region while the data — and therefore every participant — lives on
    partitions in the other regions.  Commit then always crosses region
    boundaries, which is the scenario where the number of round trips on
    the critical path (Table 3) dominates caller latency.
    """

    def __init__(self, nodes: Sequence[str], placement, home_region: str,
                 **kw):
        self.home_region = home_region
        self.placement = dict(placement)
        remote = [n for n in nodes
                  if self.placement.get(n) != home_region]
        # Degenerate placements (everything in the home region) fall back to
        # plain YCSB over all nodes rather than generating empty txns.
        super().__init__(remote or list(nodes), **kw)


class TPCCWorkload:
    """NewOrder + Payment (50/50), simplified to their lock footprints."""

    def __init__(self, nodes: Sequence[str], n_warehouses: int,
                 seed: int = 0, remote_item_prob: float = 0.01):
        assert n_warehouses >= 1
        self.nodes = list(nodes)
        self.W = n_warehouses
        self.rng = random.Random(seed)
        self.remote_prob = remote_item_prob
        self._seq = 0

    def _wh_node(self, w: int) -> str:
        return self.nodes[w % len(self.nodes)]

    def next_txn(self, coordinator: str) -> Txn:
        self._seq += 1
        rng = self.rng
        w = rng.randrange(self.W)
        home = self._wh_node(w)
        d = rng.randrange(10)
        accesses: List[Access] = []
        if rng.random() < 0.5:
            # Payment: W_YTD (hot!), district, customer — all writes.
            accesses.append((home, f"WH{w}", True))
            accesses.append((home, f"D{w}.{d}", True))
            accesses.append((home, f"C{w}.{d}.{rng.randrange(3000)}", True))
            # 15% remote customer payment.
            if rng.random() < 0.15 and self.W > 1:
                rw = rng.randrange(self.W)
                accesses.append((self._wh_node(rw),
                                 f"C{rw}.{rng.randrange(10)}.{rng.randrange(3000)}",
                                 True))
            name = "payment"
        else:
            # NewOrder: district next_o_id (hot), warehouse (read),
            # 5–15 stock rows, ~1% on remote warehouses.
            accesses.append((home, f"WH{w}", False))
            accesses.append((home, f"D{w}.{d}", True))
            for _ in range(rng.randrange(5, 16)):
                if rng.random() < self.remote_prob and self.W > 1:
                    sw = rng.randrange(self.W)
                else:
                    sw = w
                accesses.append((self._wh_node(sw),
                                 f"S{sw}.{rng.randrange(100_000)}", True))
            name = "neworder"
        # Dedup identical keys, keep strongest mode.
        merged = {}
        for node, key, wr in accesses:
            merged[(node, key)] = merged.get((node, key), False) or wr
        acc = [(n, k, wmode) for (n, k), wmode in merged.items()]
        return Txn(f"tpcc-{name}-{coordinator}-{self._seq}", coordinator, acc)
