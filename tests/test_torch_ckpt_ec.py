"""Twin of ``tests/test_ckpt_ec.py`` on the port's modules
(``repro_torch.ckpt`` / ``repro_torch.core``): the same assertions,
parametrisations and hypothesis settings.

Erasure-coded checkpoint shards: codec, commit placement, restore.

The headline property: a (k=2, n=5) epoch restores from TWO surviving
replica volumes — a *minority* — including when volumes keep dying in the
middle of the restore's per-host reads.

Where each reference test is held:

  test_every_k_subset_decodes       tests/test_torch_ckpt.py::
                                    test_ec_codec_matches_the_reference_
                                    byte_for_byte (both packages' fragments
                                    and decodes)
  test_ec_requires_replicated_store tests/test_torch_ckpt.py::
                                    test_erasure_coding_needs_a_replicated_
                                    store
  every other test                  here, under its own name

The params tree restored from a minority is the port's model, loaded from
JAX-initialized params through ``repro_torch.convert``.  Beyond the
reference's cases: both packages place the same fragment on each volume,
and an EC epoch committed by either package restores in the other from a
minority of volumes.
"""
from __future__ import annotations

import random
import threading

import numpy as np
import pytest

from conftest import hypothesis_or_stubs

torch = pytest.importorskip("torch")

from repro_torch.ckpt import shards  # noqa: E402
from repro_torch.ckpt.commit import CornusCheckpointer  # noqa: E402
from repro_torch.ckpt.restore import (fetch_payloads,  # noqa: E402
                                      latest_committed)
from repro_torch.ckpt.shards import ec_decode, ec_encode  # noqa: E402
from repro_torch.core.control import QuorumUnavailable  # noqa: E402
from repro_torch.core.state import Decision  # noqa: E402
from repro_torch.core.storage import ReplicatedStore  # noqa: E402

HAS_HYPOTHESIS, given, settings, st = hypothesis_or_stubs()


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------
def test_codec_edge_payloads():
    for payload in (b"", b"x", b"ab" * 1000):
        frags = ec_encode(payload, 3, 5)
        assert ec_decode(frags[2:]) == payload


def test_storage_overhead_is_n_over_k():
    payload = bytes(1200)
    frags = ec_encode(payload, 3, 5)
    body = len(frags[0]) - 15            # header is 15 bytes
    assert body == 400                   # ceil(1200/3) per fragment


def test_codec_rejects_bad_inputs():
    frags = ec_encode(b"hello world", 3, 5)
    with pytest.raises(ValueError, match="3 distinct"):
        ec_decode(frags[:2])
    with pytest.raises(ValueError, match="3 distinct"):
        ec_decode([frags[0], frags[0], frags[0]])   # duplicates don't count
    with pytest.raises(ValueError, match="magic"):
        ec_decode([b"XXXX" + frags[0][4:]])
    with pytest.raises(ValueError, match="truncated"):
        ec_decode([frags[0][:4]])
    other = ec_encode(b"hello world", 2, 5)
    with pytest.raises(ValueError, match="geometries"):
        ec_decode([frags[0], other[1], frags[2]])
    with pytest.raises(ValueError):
        ec_encode(b"x", 4, 3)            # k > n


@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=2048), st.integers(1, 6), st.integers(0, 5),
       st.integers(0, 10_000))
def test_codec_roundtrip_property(payload, k, extra, seed):
    n = k + extra
    frags = ec_encode(payload, k, n)
    rng = random.Random(seed)
    keep = rng.sample(frags, rng.randint(k, n))
    assert ec_decode(keep) == payload


# ---------------------------------------------------------------------------
# Commit placement + restore under volume loss
# ---------------------------------------------------------------------------
def _commit_epoch(store, hosts, payloads, epoch, ec_k, pkg=None):
    """All hosts vote concurrently (an epoch only commits collectively);
    ``pkg`` is another package's ``CornusCheckpointer``."""
    cls = pkg or CornusCheckpointer
    cks = {h: cls(store, h, hosts, ec_k=ec_k, straggler_timeout_s=5.0,
                  poll_interval_s=0.005) for h in hosts}
    outs = {}
    threads = [threading.Thread(
        target=lambda h=h: outs.update({h: cks[h].save(epoch, payloads[h])}),
        daemon=True) for h in hosts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive()
    return outs


def test_ec_epoch_commits_and_places_fragments_per_volume():
    store = ReplicatedStore(n_replicas=5)
    hosts = ["h0", "h1"]
    payloads = {h: random.Random(h).randbytes(2000) for h in hosts}
    outs = _commit_epoch(store, hosts, payloads, 3, ec_k=2)
    assert all(o.decision == Decision.COMMIT for o in outs.values())
    assert latest_committed(store, hosts) == 3
    # One distinct fragment per replica volume, none holds the payload.
    name = "e000000000003.ec"
    bodies = {r.index: r.get_data("h0", name)[1] for r in store.replicas}
    assert len(set(bodies.values())) == 5
    assert all(len(b) < len(payloads["h0"]) for b in bodies.values())


def test_restore_from_minority_with_volumes_dying_mid_restore():
    store = ReplicatedStore(n_replicas=5)
    hosts = ["h0", "h1", "h2"]
    payloads = {h: random.Random(h).randbytes(3000) for h in hosts}
    _commit_epoch(store, hosts, payloads, 7, ec_k=2)

    # Kill THREE of five volumes between the first and second host read:
    # the rest of the restore runs from a 2/5 minority.
    def after_host(h):
        if h == "h0":
            for i in (0, 1, 2):
                store.replicas[i].drop_data()

    got = fetch_payloads(store, hosts, 7, after_host=after_host)
    assert got == payloads


def test_restore_fails_below_k_surviving_fragments():
    store = ReplicatedStore(n_replicas=5)
    hosts = ["h0"]
    payloads = {"h0": b"q" * 1000}
    _commit_epoch(store, hosts, payloads, 1, ec_k=3)
    for i in (0, 1, 4):
        store.replicas[i].drop_data()    # 2 fragments < k=3 survive
    assert fetch_payloads(store, hosts, 1) == {}


def test_vote_needs_k_placeable_fragments():
    store = ReplicatedStore(n_replicas=5)
    ck = CornusCheckpointer(store, "h0", ["h0"], ec_k=3)
    for i in range(3):
        store.fail_replica(i)            # 2 alive < k=3
    with pytest.raises(QuorumUnavailable):
        ck.vote(0, b"payload")


def test_plain_epochs_still_restore_alongside_ec():
    """Plain and EC epochs coexist: restore tries the plain path first."""
    store = ReplicatedStore(n_replicas=5)
    hosts = ["h0"]
    _commit_epoch(store, hosts, {"h0": b"old" * 100}, 1, ec_k=None)
    _commit_epoch(store, hosts, {"h0": b"new" * 100}, 2, ec_k=2)
    assert fetch_payloads(store, hosts, 1) == {"h0": b"old" * 100}
    assert fetch_payloads(store, hosts, 2) == {"h0": b"new" * 100}


def test_restore_params_tree_from_minority():
    pytest.importorskip("jax")
    from test_torch_ckpt import jax_state, port_state

    from repro.ckpt import shards as jshards
    from repro_torch import ckpt, convert
    from repro_torch.configs import get_config
    from repro_torch.models import smoke

    cfg = smoke(get_config("llama3.2-1b"))
    want = jshards._flatten(jax_state("llama3.2-1b")["params"])
    params = convert.params_from_numpy(cfg, want, device="cpu")
    hosts = ["h0", "h1"]
    buckets = ckpt.partition_leaves(params, len(hosts))
    payloads = {h: ckpt.pack_tree(params, keys)
                for h, keys in zip(hosts, buckets)}
    store = ReplicatedStore(n_replicas=5)
    _commit_epoch(store, hosts, payloads, 9, ec_k=2)
    for i in (1, 2, 3):
        store.replicas[i].drop_data()
    template = port_state("llama3.2-1b", seed=11)["params"]
    got = shards._flatten(ckpt.restore_params(store, hosts, 9, template))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------
def _jax_ckpt():
    pytest.importorskip("jax")
    import repro.ckpt.commit as jcommit
    import repro.ckpt.restore as jrestore
    import repro.core.state as jstate
    import repro.core.storage as jstorage
    return jcommit, jrestore, jstate, jstorage


def _mount(src, dst, vote) -> None:
    """Every volume of ``src`` (one package's ReplicatedStore) mounted in
    ``dst`` (the other's): each replica's state slots, with ``vote`` the
    reading package's enum, and its payloads at their versions."""
    for a, b in zip(src.replicas, dst.replicas):
        for key in a.keys():
            value, gen, decided = a.read(key)
            b.repair(key, None if value is None else vote[value.name], gen,
                     decided, a._slots[key].writer)
        for part, name in a.data_keys():
            version, payload = a.get_data(part, name)
            b.put_data(part, name, payload, version=version)


def test_both_packages_place_the_same_fragments():
    """The same EC epoch committed by each package: every volume holds
    the same fragment bytes at the same version, and the merged state
    slots agree by name."""
    jcommit, _jrestore, _jstate, jstorage = _jax_ckpt()
    hosts = ["h0", "h1", "h2"]
    payloads = {h: random.Random(h).randbytes(2500) for h in hosts}
    images = []
    for store, cls in ((ReplicatedStore(n_replicas=5), None),
                       (jstorage.ReplicatedStore(n_replicas=5),
                        jcommit.CornusCheckpointer)):
        outs = _commit_epoch(store, hosts, payloads, 4, ec_k=2, pkg=cls)
        assert all(o.decision.name == "COMMIT" for o in outs.values())
        images.append((
            [sorted((k, r.get_data(*k)) for k in r.data_keys())
             for r in store.replicas],
            sorted((k, v.name) for k, v in store.snapshot().items())))
    assert images[0] == images[1]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ec_epoch_restores_across_packages_from_a_minority(writer):
    """An EC epoch committed by one package, its five volumes mounted in
    the other's store with three of them lost: the reader finds the epoch
    committed and restores every host's payload from the two left."""
    jcommit, jrestore, jstate, jstorage = _jax_ckpt()
    from repro_torch.core.state import Vote
    hosts = ["h0", "h1", "h2"]
    payloads = {h: random.Random(h + writer).randbytes(3000) for h in hosts}
    port_store = ReplicatedStore(n_replicas=5)
    jax_store = jstorage.ReplicatedStore(n_replicas=5)
    if writer == "port":
        src, dst, vote = port_store, jax_store, jstate.Vote
        read_latest, read_fetch = (jrestore.latest_committed,
                                   jrestore.fetch_payloads)
        _commit_epoch(src, hosts, payloads, 6, ec_k=2)
    else:
        src, dst, vote = jax_store, port_store, Vote
        read_latest, read_fetch = latest_committed, fetch_payloads
        _commit_epoch(src, hosts, payloads, 6, ec_k=2,
                      pkg=jcommit.CornusCheckpointer)
    _mount(src, dst, vote)
    for i in (0, 2, 4):
        dst.replicas[i].drop_data()
    assert read_latest(dst, hosts) == 6
    assert read_fetch(dst, hosts, 6) == payloads
