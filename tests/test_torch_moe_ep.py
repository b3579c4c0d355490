"""The port's expert-parallel MoE against the JAX package's
``_moe_shardmap``, on four CPU ranks.

The JAX side runs in a subprocess with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
src/repro/launch/dryrun.py sets it) and writes its outputs to an npz; the
test process's jax keeps its one device.  The torch side is four gloo ranks
from ``torch.multiprocessing.spawn`` with a ``file://`` rendezvous in the
test's temporary directory; every collective has a timeout and the join is
bounded, so a hang fails the test.  Both sides run at once.

Every case is ``smoke(kimi-k2)`` (8 experts top-2, one shared expert) on a
(data, model) mesh and T tokens, the weights and tokens drawn with numpy:

  case     mesh    T   the reference's token regime
  1x4-T16  (1, 4)  16  over batch + expert
  1x4-T2   (1, 4)   2  over batch only (a data axis of 1; a decode batch)
  2x2-T8   (2, 2)   8  over batch + expert
  2x2-T6   (2, 2)   6  over batch only
  2x2-T5   (2, 2)   5  replicated

Each shard sizes its capacity from its own tokens and drops past it, so
where a shard holds fewer than T tokens the shard map's output can part from
the single shard's (here at 1x4-T16, 2x2-T8 and 2x2-T6, whose two requests
are the same 3 tokens): the port's expert-parallel path is held to the
shard map at 2e-5, and shown to part from its own single-shard path exactly
where, and by as much as, the JAX package's does.

The gradients of a fixed linear functional of the output (each case's
cotangent ``ct_*`` drawn with numpy) plus the aux loss, with respect to x,
the router, the shared expert and each rank's block of the expert leaves,
are held to ``jax.grad`` of the same functional of the shard map; and the
gradient with respect to each rank's gates through ``moe.dispatch`` and
``_combine`` to ``jax.grad`` through ``_moe_shardmap``, zero on both sides
at every assignment the shard's capacity dropped.

    python tests/test_torch_moe_ep.py --jax IN.npz OUT.npz   # JAX side
"""
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
ARCH = "kimi-k2-1t-a32b"
WORLD = 4
TOL = 2e-5                 # fp32 (tests/test_kernels.py:28)
# name: ((data, model), (B, S)) of x; T = B·S.
CASES = {"1x4-T16": ((1, 4), (2, 8)),
         "1x4-T2": ((1, 4), (2, 1)),
         "2x2-T8": ((2, 2), (2, 4)),
         "2x2-T6": ((2, 2), (2, 3)),
         "2x2-T5": ((2, 2), (1, 5))}
# The cases whose shard capacities drop other assignments than the single
# shard's.
PARTS = ("1x4-T16", "2x2-T8", "2x2-T6")
# The cases where a shard's own capacity drops assignments: at 2x2-T5 each
# shard routes all 5 tokens at the single shard's capacity; at 2x2-T8 and
# 2x2-T6 only the single shard drops.
SHARD_DROPS = ("1x4-T16", "2x2-T5")
PROMPT, MAX_LEN = (2, 8), 16     # the LM check: smoke kimi on mesh (1, 4)
TIMEOUT_S = 120                  # each side, from its start


def smoke_cfg():
    from repro_torch.configs import get_config
    from repro_torch.models import smoke
    return smoke(get_config(ARCH))


def make_inputs(path):
    """The MoE leaves, as the port's specs shape and scale them, and one
    x per case, all from numpy seeds."""
    from repro_torch.models.moe import moe_specs
    rng = np.random.RandomState(0)
    cfg = smoke_cfg()
    inp = {n: (rng.randn(*s.shape) * s.stddev()).astype(np.float32)
           for n, s in moe_specs(cfg).items()}
    for i, (name, (_, (B, S))) in enumerate(CASES.items()):
        inp[f"x_{name}"] = np.random.RandomState(1 + i).randn(
            B, S, cfg.d_model).astype(np.float32)
        inp[f"ct_{name}"] = np.random.RandomState(20 + i).randn(
            B, S, cfg.d_model).astype(np.float32)
    # Two identical requests: an expert that two of the 3 tokens pick takes
    # 4 assignments against the single shard's capacity of 2, and 2 in each
    # data shard (capacity 2 of its own).
    inp["x_2x2-T6"][1] = inp["x_2x2-T6"][0]
    inp["prompt"] = np.random.RandomState(9).randint(
        0, cfg.vocab_size, PROMPT)
    np.savez(path, **inp)


# ---------------------------------------------------------------------------
# The JAX side (run in its own process: the four devices must exist before
# jax is imported)
# ---------------------------------------------------------------------------
def jax_side(inp_path, out_path):
    from functools import partial

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.launch.mesh import make_host_mesh
    from repro.launch.sharding import make_rules, use_rules
    from repro.models import moe
    from repro.models.config import smoke
    assert len(jax.devices()) == WORLD, jax.devices()
    cfg = smoke(get_config(ARCH))
    inp = np.load(inp_path)
    params = {n: jnp.asarray(inp[n]) for n in moe.moe_specs(cfg)}
    out = {}
    for name, ((dp, ep), _) in CASES.items():
        x = jnp.asarray(inp[f"x_{name}"])
        mesh = make_host_mesh(model=ep)
        assert mesh.devices.shape == (dp, ep)
        with use_rules(make_rules(mesh)):
            y, aux = jax.jit(partial(moe.moe_apply, cfg))(params, x)
        single, _ = moe.moe_apply(cfg, params, x)
        out[f"out_{name}"] = np.asarray(y)
        out[f"aux_{name}"] = np.asarray(aux)
        out[f"single_{name}"] = np.asarray(single)
        ct = jnp.asarray(inp[f"ct_{name}"])
        rules = make_rules(mesh)

        def functional(p, x):
            with use_rules(rules):
                y, aux = moe.moe_apply(cfg, p, x)
            return jnp.sum(y * ct) + aux

        gp, gx = jax.jit(jax.grad(functional, argnums=(0, 1)))(params, x)
        out[f"grad_{name}/x"] = np.asarray(gx)
        for n, g in gp.items():
            out[f"grad_{name}/{n}"] = np.asarray(g)
        # Through the shard map alone, with respect to the gates.
        xf = x.reshape(-1, cfg.d_model)
        gates, ids, _ = moe._route(cfg, params["router"], xf)

        def through_gates(g):
            with use_rules(rules):
                y = moe._moe_shardmap(cfg, params, xf, g, ids, rules, ep)
            return jnp.sum(y * ct.reshape(y.shape))

        out[f"gates_grad_{name}"] = np.asarray(
            jax.jit(jax.grad(through_gates))(gates))
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# The torch side: one spawned process per rank
# ---------------------------------------------------------------------------
def torch_rank(rank, init, inp_path, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import convert
    from repro_torch.launch.sharding import Rules, use_rules
    from repro_torch.models import init_model, moe
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        cfg = smoke_cfg()
        inp = np.load(inp_path)
        full = {n: torch.from_numpy(inp[n]) for n in moe.moe_specs(cfg)}
        res = {}
        for name, ((dp, ep), _) in CASES.items():
            mesh = init_device_mesh("cpu", (dp, ep),
                                    mesh_dim_names=("data", "model"))
            rules = Rules(mesh)
            params = convert.expert_block(
                full, mesh.get_local_rank("model"), ep)
            x = torch.from_numpy(inp[f"x_{name}"])
            with use_rules(rules), torch.no_grad():
                y, aux = moe.moe_apply(cfg, params, x)
            res[f"out_{name}"] = y.numpy()
            res[f"aux_{name}"] = aux.numpy()
            res[f"sizes_{name}"] = np.array([rules.axis_size("batch"),
                                             rules.axis_size("expert")])
            res.update(rank_grads(cfg, name, params, x, inp, rules, mesh))

        # The LM: smoke kimi's single-shard prefill and one decode step;
        # then its experts cut to this rank's block on mesh (1, 4), the
        # prefill again (T = 16: each shard's capacity is its own) and the
        # decode step on a copy of the single shard's cache (T = 2: the
        # same capacity as the single shard's).
        mesh = init_device_mesh("cpu", (1, WORLD),
                                mesh_dim_names=("data", "model"))
        model = init_model(cfg, 0, device="cpu")
        prompt = {"tokens": torch.from_numpy(inp["prompt"])}
        _, cache, pos = model.prefill(prompt, MAX_LEN)
        step = {"tokens": torch.from_numpy(inp["prompt"][:, :1])}
        clone = _clone_cache(cache)
        res["lm_single_decode"], _ = model.decode_step(step, cache, pos)
        _shard_experts(model, mesh.get_local_rank("model"), WORLD)
        with use_rules(Rules(mesh)):
            res["lm_ep_prefill"], _, _ = model.prefill(prompt, MAX_LEN)
            res["lm_ep_decode"], _ = model.decode_step(step, clone, pos)
        res["lm_experts_held"] = np.array(
            model.layers[0]["ffn"]["moe"]["w_gate"].shape[0])
        for k in ("lm_single_decode", "lm_ep_prefill", "lm_ep_decode"):
            res[k] = res[k].numpy()
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def rank_grads(cfg, name, params, x, inp, rules, mesh):
    """This rank's gradients of sum(out · ct) + aux with respect to x, the
    router, the shared expert and its block of the expert leaves; and of
    its token shard's sum(out · ct) with respect to the shard's gates
    through ``moe.dispatch`` and ``_combine``, beside the assignments the
    shard's capacity kept."""
    from repro_torch.launch.sharding import use_rules
    from repro_torch.models import moe
    ct = torch.from_numpy(inp[f"ct_{name}"])
    leaves = {n: t.clone().requires_grad_() for n, t in params.items()}
    xg = x.clone().requires_grad_()
    with use_rules(rules):
        y, aux = moe.moe_apply(cfg, leaves, xg)
        grads = torch.autograd.grad((y * ct).sum() + aux,
                                    [xg] + list(leaves.values()))
    res = {f"grad_{name}/x": grads[0].numpy()}
    res.update({f"grad_{name}/{n}": g.numpy()
                for n, g in zip(leaves, grads[1:])})
    ep = rules.axis_size("expert")
    e, k, d = cfg.n_experts, cfg.experts_per_token, cfg.d_model
    xf, ctf = x.reshape(-1, d), ct.reshape(-1, d)
    gates, ids, _ = moe._route(cfg, params["router"], xf)
    tok_axes, t_local, cap = moe.token_split(cfg, rules, xf.shape[0], ep)
    shard = 0
    for a in tok_axes:
        shard = shard * rules.sizes[a] + mesh.get_local_rank(a)
    rows = slice(shard * t_local, (shard + 1) * t_local)
    g = gates[rows].detach().requires_grad_()
    buf, slot, keep = moe._fill_capacity_buffers(xf[rows], g, ids[rows], e,
                                                 cap)
    out = moe._combine(
        moe.dispatch({n: params[n] for n in moe.EXPERT_LEAVES}, buf,
                     (mesh, mesh.mesh_dim_names.index("model")), ep),
        slot, keep, g, t_local, k)
    (gg,) = torch.autograd.grad((out * ctf[rows]).sum(), [g])
    res[f"gates_grad_{name}"] = gg.numpy()
    res[f"keep_{name}"] = keep.reshape(t_local, k).numpy()
    res[f"rows_{name}"] = np.array([rows.start, rows.stop])
    res[f"model_rank_{name}"] = np.array(mesh.get_local_rank("model"))
    return res


def _shard_experts(model, rank, ep):
    """``model`` with every MoE layer's experts cut to rank ``rank``'s
    block (``convert.expert_block``), in place."""
    from repro_torch import convert
    from repro_torch.models.moe import EXPERT_LEAVES
    for layer in model.layers:
        if "ffn" not in layer or "moe" not in layer["ffn"]:
            continue
        tree = layer["ffn"]["moe"]
        block = convert.expert_block(
            {n: tree[n].detach() for n in EXPERT_LEAVES}, rank, ep)
        for name, t in block.items():
            setattr(tree, name, torch.nn.Parameter(
                t, requires_grad=tree[name].requires_grad))
    return model


def _clone_cache(cache):
    if isinstance(cache, dict):
        return {k: _clone_cache(v) for k, v in cache.items()}
    return cache.clone()


def single_shard(name, inp):
    """The port's single-shard branch on the same inputs (no rules)."""
    from repro_torch.models import moe
    cfg = smoke_cfg()
    full = {n: torch.from_numpy(inp[n]) for n in moe.moe_specs(cfg)}
    with torch.no_grad():
        y, _ = moe.moe_apply(cfg, full, torch.from_numpy(inp[f"x_{name}"]))
    return y.numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides, once: (inputs, JAX outputs, each rank's outputs)."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    inp_path, jax_path = tmp / "inputs.npz", tmp / "jax.npz"
    make_inputs(inp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT)]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    jax_proc = subprocess.Popen(
        [sys.executable, __file__, "--jax", str(inp_path), str(jax_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        ctx = torch.multiprocessing.spawn(
            torch_rank, args=(f"file://{tmp / 'rendezvous'}", str(inp_path),
                              str(tmp)),
            nprocs=WORLD, join=False)
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the torch ranks did not end in {TIMEOUT_S} s")
        log, _ = jax_proc.communicate(timeout=max(
            1.0, deadline - time.monotonic() + 60))
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, log
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return dict(np.load(inp_path)), dict(np.load(jax_path)), ranks


@pytest.mark.parametrize("name", list(CASES))
def test_expert_parallel_matches_jax_shard_map(name, runs):
    """Output and aux within fp32 2e-5 of the JAX package's shard map, on
    every rank, and every rank's output the same."""
    _, want, ranks = runs
    (dp, ep), (B, S) = CASES[name]
    for r, got in enumerate(ranks):
        assert got[f"out_{name}"].shape == (B, S, 64)
        np.testing.assert_allclose(got[f"out_{name}"], want[f"out_{name}"],
                                   rtol=TOL, atol=TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got[f"aux_{name}"], want[f"aux_{name}"],
                                   rtol=TOL, atol=TOL, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got[f"out_{name}"],
                                      ranks[0][f"out_{name}"])
        np.testing.assert_array_equal(got[f"sizes_{name}"], [dp, ep])


@pytest.mark.parametrize("name", list(CASES))
def test_expert_parallel_parts_from_single_shard_where_jax_does(name, runs):
    """Where the shard map's per-shard capacity parts its output from the
    single shard's (JAX's gap above 0.1), the port's expert-parallel output
    parts from the port's single-shard output by about as much; where JAX's
    gap is rounding, so is the port's.  A branch that quietly took the
    single-shard path fails here."""
    inp, want, ranks = runs
    jax_gap = float(np.abs(want[f"out_{name}"]
                           - want[f"single_{name}"]).max())
    got = ranks[0][f"out_{name}"]
    port_gap = float(np.abs(got - single_shard(name, inp)).max())
    if name in PARTS:
        assert jax_gap > 0.1
        assert port_gap == pytest.approx(jax_gap, abs=1e-4)
    else:
        assert jax_gap < TOL and port_gap < TOL


@pytest.mark.parametrize("name", list(CASES))
def test_expert_parallel_grads_match_jax_shard_map(name, runs):
    """The gradients of sum(out · ct) + aux on every rank within fp32 2e-5
    of ``jax.grad`` through the shard map: x, the router and the shared
    expert whole, ``w_gate`` / ``w_up`` / ``w_down`` as the rank's block of
    E/ep experts.  The gradient with respect to each shard's gates equals
    the JAX package's rows of it, and is zero on both sides at every
    assignment the shard dropped (some are, in ``SHARD_DROPS``)."""
    from repro_torch.models.moe import EXPERT_LEAVES
    _, want, ranks = runs
    (dp, ep), _ = CASES[name]
    el = smoke_cfg().n_experts // ep
    keys = [k for k in want if k.startswith(f"grad_{name}/")]
    assert {k.split("/")[1] for k in keys} >= {"x", "router", "ws_gate",
                                                  *EXPERT_LEAVES}
    dropped = 0
    for r, got in enumerate(ranks):
        m = int(got[f"model_rank_{name}"])
        for key in keys:
            w = want[key]
            if key.split("/")[1] in EXPERT_LEAVES:
                w = w[m * el:(m + 1) * el]
            np.testing.assert_allclose(got[key], w, rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} {key}")
        lo, hi = got[f"rows_{name}"]
        keep = got[f"keep_{name}"]
        port, jax_rows = got[f"gates_grad_{name}"], want[
            f"gates_grad_{name}"][lo:hi]
        np.testing.assert_allclose(port, jax_rows, rtol=TOL, atol=TOL,
                                   err_msg=f"rank {r} gates")
        assert not port[~keep].any() and not jax_rows[~keep].any()
        assert np.abs(port[keep]).min() > 0
        dropped += int((~keep).sum())
    assert (dropped > 0) == (name in SHARD_DROPS)


def test_sharded_lm_decodes_as_the_single_shard_model(runs):
    """smoke kimi with each rank's 2 of 8 experts (``_shard_experts``): the
    decode step (T = 2, the single shard's capacity) gives the single-shard
    logits; the prefill (T = 16) runs and every rank agrees."""
    _, _, ranks = runs
    for got in ranks:
        assert int(got["lm_experts_held"]) == 2
        np.testing.assert_allclose(got["lm_ep_decode"],
                                   got["lm_single_decode"], rtol=TOL,
                                   atol=TOL)
        assert np.isfinite(got["lm_ep_prefill"]).all()
        np.testing.assert_array_equal(got["lm_ep_prefill"],
                                      ranks[0]["lm_ep_prefill"])


def test_expert_block_cuts_each_ranks_experts():
    from repro_torch import convert
    from repro_torch.models.moe import EXPERT_LEAVES, moe_specs
    leaves = {n: torch.randn(s.shape) for n, s in
              moe_specs(smoke_cfg()).items()}
    blocks = [convert.expert_block(leaves, r, 4) for r in range(4)]
    for name, t in leaves.items():
        if name in EXPERT_LEAVES:
            assert all(b[name].shape[0] == 2 for b in blocks)
            torch.testing.assert_close(torch.cat([b[name] for b in blocks]),
                                       t, rtol=0, atol=0)
        else:
            assert all(b[name] is t for b in blocks), name
    for rank, ep in ((4, 4), (-1, 4), (0, 3)):
        with pytest.raises(ValueError, match="cannot hold"):
            convert.expert_block(leaves, rank, ep)


def test_rules_take_no_override_of_the_logical_names():
    """What this test guarded: no caller can run the expert-parallel MoE
    with "batch" and "expert" on one mesh dim.  ``Rules`` takes the
    reference's override of the logical names again (the sharding
    profiles need it), so the guard is the MoE's own: it refuses such
    rules with ``ValueError`` before any collective
    (tests/test_torch_sharding.py holds the same beside the reference's
    shard map, on a fake (1, 4) mesh)."""
    import types

    from repro_torch.launch.sharding import Rules, use_rules
    from repro_torch.models.moe import moe_apply, moe_specs
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(1, 4))
    assert Rules(mesh, {"expert": ("data",)}).logical["expert"] == \
        ("data",)
    rules = Rules(mesh, {"batch": ("data", "model")})
    assert rules.logical["expert"] == ("model",)
    assert rules.axis_size("expert") == 4
    cfg = smoke_cfg()
    params = {n: torch.randn(s.shape) * s.stddev()
              for n, s in moe_specs(cfg).items()}
    with torch.no_grad(), use_rules(rules), \
            pytest.raises(ValueError, match="needs them apart"):
        moe_apply(cfg, params, torch.randn(2, 8, cfg.d_model))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
        jax_side(sys.argv[2], sys.argv[3])
