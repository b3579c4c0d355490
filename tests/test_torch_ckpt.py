"""Checkpoint interchange between the port and the JAX package, on the CPU.

An epoch that either package commits through its ``CornusCheckpointer``
into a ``FileStore`` directory is found and restored by the other, leaf by
leaf: the parameters, and the AdamW moments m and v.  The host partition,
the npz keys, dtypes and shapes, and the erasure-coded fragments are the
reference's; the port's ``MemoryStore`` / ``FileStore`` pass the parts of
``tests/test_store_api.py`` and ``tests/test_ckpt_commit.py`` that apply to
them, and both packages' stores read each other's state files.
"""
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import ckpt as jckpt  # noqa: E402
from repro.ckpt import shards as jshards  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import storage as jstorage  # noqa: E402
from repro.core.state import Vote as JVote  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import ckpt, convert  # noqa: E402
from repro_torch.ckpt import shards  # noqa: E402
from repro_torch.ckpt.commit import AsyncCheckpointer, _txn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (DecisionCacheConfig, EwmaStat,  # noqa: E402
                              FileStore, LeaseKeeper, MemoryStore, Vote)
from repro_torch.core.state import Decision  # noqa: E402
from repro_torch.models import smoke  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

HOSTS = ["host0", "host1", "host2", "host3"]
ARCHS = ["llama3.2-1b", "xlstm-125m", "jamba-v0.1-52b"]


def jax_state(arch, seed=0, dtype=jnp.float32):
    """A JAX training state: params from init, moments random (numpy)."""
    jcfg = jmc.smoke(jget_config(arch))
    params = jlm.init_model(jcfg, jax.random.key(seed))
    rng = np.random.RandomState(seed + 1)

    def moment(p):
        return jnp.asarray(rng.rand(*p.shape).astype(np.float32), dtype)

    return {"params": params,
            "opt": {"m": jax.tree_util.tree_map(moment, params),
                    "v": jax.tree_util.tree_map(moment, params)}}


def port_state(arch, state_dtype=torch.float32, seed=3):
    """A port training state of the same config, with other numbers."""
    cfg = smoke(get_config(arch))
    flat = {k: v + seed for k, v in
            jshards._flatten(jax_state(arch, seed)["params"]).items()}
    model = convert.params_from_numpy(cfg, flat, device="cpu")
    opt = adamw_init(dict(model.named_parameters()),
                     AdamWConfig(state_dtype=state_dtype))
    g = torch.Generator().manual_seed(seed)
    for part in ("m", "v"):
        for t in opt[part].values():
            t.copy_(torch.rand(t.shape, generator=g))
    return {"params": model, "opt": {"m": opt["m"], "v": opt["v"]}}


def as_f32(a):
    """A leaf's values as fp32: raw bf16 bits (V2) included."""
    a = np.asarray(a)
    if a.dtype == np.dtype("V2") or a.dtype.name == "bfloat16":
        bits = a.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    return a.astype(np.float32)


def commit(jax_side, store, state, epoch, hosts=HOSTS):
    """Every host votes its shards, then the epoch resolves, as the
    training drivers do."""
    pkg = jckpt if jax_side else ckpt
    parts = pkg.partition_leaves(state, len(hosts))
    cks = [pkg.CornusCheckpointer(store, h, hosts) for h in hosts]
    for ck, keys in zip(cks, parts):
        ck.vote(epoch, pkg.pack_tree(state, keys))
    decision, forced = cks[0].resolve(epoch)
    assert decision.value == "COMMIT" and forced == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_port_restores_an_epoch_the_jax_package_committed(arch, tmp_path):
    jstate = jax_state(arch)
    commit(True, jstorage.FileStore(str(tmp_path)), jstate, 7)
    store = FileStore(str(tmp_path))
    assert ckpt.latest_committed(store, HOSTS) == 7
    state = port_state(arch)
    ckpt.restore_params(store, HOSTS, 7, state)
    got, want = shards._flatten(state), jshards._flatten(jstate)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_package_restores_an_epoch_the_port_committed(arch, tmp_path):
    state = port_state(arch)
    commit(False, FileStore(str(tmp_path)), state, 4)
    store = jstorage.FileStore(str(tmp_path))
    assert jckpt.latest_committed(store, HOSTS) == 4
    template = jax_state(arch, seed=5)
    restored = jckpt.restore_params(store, HOSTS, 4, template)
    got, want = jshards._flatten(restored), shards._flatten(state)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_payloads_hold_the_reference_keys_dtypes_and_shapes(arch):
    jstate = jax_state(arch)
    state = port_state(arch)
    shards.merge_into_tree(state, jshards._flatten(jstate))
    for n_hosts in (1, 2, 3, 4):
        parts = shards.partition_leaves(state, n_hosts)
        assert parts == jshards.partition_leaves(jstate, n_hosts)
        for keys in parts:
            got = shards.unpack_tree(shards.pack_tree(state, keys))
            want = jshards.unpack_tree(jshards.pack_tree(jstate, keys))
            assert list(got) == list(want) == keys
            for k in keys:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bf16_moments(tmp_path):
    """The JAX package's bf16 leaves reach np.savez as 2-byte void ('<V2')
    holding the bf16 bits.  The port writes its bf16 moments as the same
    bytes (numpy names the dtype '|V2' without ml_dtypes), restores its own
    epoch exactly, and restores the JAX package's bf16 epoch exactly."""
    arch = "llama3.2-1b"
    state = port_state(arch, state_dtype=torch.bfloat16)
    keys = [k for k in shards.partition_leaves(state, 1)[0]
            if k.startswith("opt/")]
    flat = shards.unpack_tree(shards.pack_tree(state, keys))
    assert all(flat[k].dtype == np.dtype("V2") for k in keys)
    # Own round trip through a committed epoch.
    commit(False, FileStore(str(tmp_path / "port")), state, 2)
    back = port_state(arch, state_dtype=torch.bfloat16, seed=9)
    ckpt.restore_params(FileStore(str(tmp_path / "port")), HOSTS, 2, back)
    for part in ("m", "v"):
        for n, t in state["opt"][part].items():
            assert back["opt"][part][n].dtype == torch.bfloat16
            assert torch.equal(back["opt"][part][n], t), n
    # The JAX package's bf16 moments carry the same bits.
    jstate = jax_state(arch, dtype=jnp.bfloat16)
    jflat = jshards.unpack_tree(jshards.pack_tree(jstate))
    port_bits = shards.unpack_tree(shards.pack_tree(
        shards.merge_into_tree(back, jflat)))
    for k, a in jflat.items():
        np.testing.assert_array_equal(as_f32(port_bits[k]), as_f32(a),
                                      err_msg=k)


def test_ec_codec_matches_the_reference_byte_for_byte():
    rng = np.random.RandomState(0)
    for size in (0, 1, 17, 4096, 100_003):
        payload = rng.randint(0, 256, size).astype(np.uint8).tobytes()
        for k, n in ((1, 1), (2, 5), (3, 4), (4, 7)):
            frags = shards.ec_encode(payload, k, n)
            assert frags == jshards.ec_encode(payload, k, n)
            # Any k fragments decode, in either package.
            for start in range(n - k + 1):
                some = frags[start:start + k]
                assert shards.ec_decode(some) == payload
                assert jshards.ec_decode(some) == payload
    with pytest.raises(ValueError):
        shards.ec_decode(shards.ec_encode(b"abc", 3, 5)[:2])


def test_file_stores_share_one_layout(tmp_path):
    """State and payload files that either package writes, the other reads;
    the two trees of files are the same."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for root, store in ((jdir, jstorage.FileStore(str(jdir))),
                        (pdir, FileStore(str(pdir)))):
        vote = JVote if isinstance(store, jstorage.FileStore) else Vote
        store.log_once("h0", _txn(3), vote.VOTE_YES, writer="h0")
        store.log_once("h1", _txn(3), vote.ABORT, writer="restore")
        store.put_data("h0", _txn(3), b"payload")

    def tree(root):
        return sorted((os.path.relpath(os.path.join(d, f), root),
                       open(os.path.join(d, f), "rb").read())
                      for d, _, fs in os.walk(root) for f in fs)

    assert tree(jdir) == tree(pdir)
    assert FileStore(str(jdir)).read_state("h1", _txn(3)) == Vote.ABORT
    assert jstorage.FileStore(str(pdir)).read_state("h0", _txn(3)) \
        == JVote.VOTE_YES
    assert FileStore(str(jdir)).get_data("h0", _txn(3)) == b"payload"


# ---------------------------------------------------------------------------
# The port's stores and committer: twins of the reference's tests that
# apply to MemoryStore and FileStore (tests/test_store_api.py,
# tests/test_ckpt_commit.py).
# ---------------------------------------------------------------------------
def small_state():
    return port_state("llama3.2-1b")


def payloads_of(state, hosts):
    parts = ckpt.partition_leaves(state, len(hosts))
    return {h: ckpt.pack_tree(state, keys) for h, keys in zip(hosts, parts)}


def test_memory_store_control_plane():
    plain = MemoryStore()
    assert plain.control is None
    stormy = MemoryStore(decisions=DecisionCacheConfig(
        cache=True, singleflight=True, push=True))
    assert stormy.control is not None
    assert stormy.decision_cache_hits == 0
    assert stormy.singleflight_hits == 0
    assert stormy.decisions_pushed == 0


def test_file_store_log_once(tmp_path):
    store = FileStore(str(tmp_path))
    assert store.log_once("h0", "t1", Vote.VOTE_YES, writer="h0") \
        == Vote.VOTE_YES
    assert store.log_once("h0", "t1", Vote.ABORT, writer="h1") \
        == Vote.VOTE_YES                          # first writer wins


def test_ewma_stat_matches_legacy_update_law():
    st = EwmaStat()
    ewma, dev = None, 0.0
    for ms in (4.0, 12.0, 2.0, 40.0, 7.5):
        st.note(ms)
        if ewma is None:
            ewma, dev = ms, ms / 4.0
        else:
            dev = 0.75 * dev + 0.25 * abs(ms - ewma)
            ewma = 0.75 * ewma + 0.25 * ms
    assert st.ewma == pytest.approx(ewma)
    assert st.dev == pytest.approx(dev)


def test_lease_keeper_unsupported_store_is_slow_path():
    keeper = LeaseKeeper(MemoryStore(), holder="h0")
    assert not keeper.supported
    assert keeper.ensure() is None and keeper.failures == 0


def test_memorystore_cas_concurrency():
    store = MemoryStore()
    winners = []
    lock = threading.Lock()

    def racer(i):
        r = store.log_once("p", "t", Vote.VOTE_YES if i % 2 else Vote.ABORT,
                           writer=f"w{i}")
        with lock:
            winners.append(r)

    ts = [threading.Thread(target=racer, args=(i,)) for i in range(16)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert len(set(winners)) == 1


@pytest.mark.parametrize("backend", ["memory", "file"])
def test_all_hosts_commit_and_restore(backend, tmp_path):
    store = MemoryStore() if backend == "memory" else FileStore(str(tmp_path))
    state = small_state()
    payloads = payloads_of(state, HOSTS)
    outs = {}

    def run(h):
        outs[h] = ckpt.CornusCheckpointer(store, h, HOSTS).save(1, payloads[h])

    ts = [threading.Thread(target=run, args=(h,)) for h in HOSTS]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert all(o.decision == Decision.COMMIT for o in outs.values())
    assert ckpt.latest_committed(store, HOSTS) == 1
    flat = {}
    for p in ckpt.fetch_payloads(store, HOSTS, 1).values():
        flat.update(ckpt.unpack_tree(p))
    assert sorted(flat) == sorted(shards._flatten(state))


def test_straggler_is_force_aborted_not_waited_on(tmp_path):
    store = FileStore(str(tmp_path))
    payloads = payloads_of(small_state(), HOSTS)
    for h in HOSTS[:3]:
        ckpt.CornusCheckpointer(store, h, HOSTS).vote(2, payloads[h])
    t0 = time.monotonic()
    d, forced = ckpt.CornusCheckpointer(
        store, "host0", HOSTS, straggler_timeout_s=0.2).resolve(2)
    assert time.monotonic() - t0 < 5.0
    assert d == Decision.ABORT and forced == 1
    late = ckpt.CornusCheckpointer(store, "host3", HOSTS)
    assert late.save(2, payloads["host3"]).decision == Decision.ABORT


def test_restart_resolves_inflight_epoch_without_blocking(tmp_path):
    store = FileStore(str(tmp_path))
    payloads = payloads_of(small_state(), HOSTS)
    for h in HOSTS:
        ckpt.CornusCheckpointer(store, h, HOSTS).vote(1, payloads[h])
    for h in HOSTS[:2]:
        ckpt.CornusCheckpointer(store, h, HOSTS).vote(2, payloads[h])
    t0 = time.monotonic()
    assert ckpt.latest_committed(store, HOSTS) == 1
    assert time.monotonic() - t0 < 2.0
    assert store.read_state("host2", _txn(2)) == Vote.ABORT


def test_async_checkpointer_commits(tmp_path):
    store = FileStore(str(tmp_path))
    payload = payloads_of(small_state(), ["host0"])["host0"]
    ck = AsyncCheckpointer(ckpt.CornusCheckpointer(store, "host0", ["host0"]))
    ck.save(5, payload)
    outs = ck.join()
    assert outs and outs[-1].decision == Decision.COMMIT
    assert ckpt.latest_committed(store, ["host0"]) == 5


def test_erasure_coding_needs_a_replicated_store():
    with pytest.raises(ValueError, match="replicated store"):
        ckpt.CornusCheckpointer(MemoryStore(), "h0", ["h0"], ec_k=2)


def test_elastic_restore_different_host_count(tmp_path):
    store = FileStore(str(tmp_path))
    state = small_state()
    commit(False, store, state, 6, hosts=HOSTS)
    back = port_state("llama3.2-1b", seed=11)
    ckpt.restore_params(store, HOSTS, 6, back)
    want = shards._flatten(state)
    got = shards._flatten(back)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # A 2-host fleet writes the next epoch; both fleets' epochs coexist.
    commit(False, store, back, 9, hosts=HOSTS[:2])
    assert ckpt.latest_committed(store, HOSTS[:2]) == 9
