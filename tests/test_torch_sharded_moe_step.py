"""The port's attention-and-MoE decoders on DTensor parameters against the
JAX package's sharded steps, on four CPU ranks.

For ``smoke(qwen3-moe-235b-a22b)`` (qk-norm, 8 experts top-2) and
``smoke(kimi-k2-1t-a32b)`` (8 experts top-2 and a shared expert), under each
profile of ``launch.sharding.PROFILES`` on a (2, 2) ("data", "model") mesh,
the same JAX-initialised weights (carried over by
``convert.params_from_numpy(..., rules=)``) and the same numpy batches go
through

  * the training forward on the train batch (4 x 8): its logits and loss;
  * the prefill step on a serving batch of 2 x 8: its logits and cache;
  * 4 decode steps against that cache: the logits;
  * 2 train steps on the train batch (lr 0 at step 0 as WSD gives it, then
    lr > 0): the losses and, after each step, every parameter and both
    AdamW moments;
  * for qwen3-moe, 2 int8-compressed train steps in float64
    (tests/test_torch_sharded_step.py's ``compressed_steps``): the same,
    and each leaf's codes and scales, the expert leaves' too, equal to the
    plain quantizer's of the gathered gradient on every rank.

Under "default" and "sp" the MoE is expert parallel (ep = 2): the train
batch's 32 tokens and the prefill's 16 are cut over batch and expert (4
shards, capacity from each shard's tokens), a decode step's 2 over batch
only; under "fsdp" the expert axis is empty and the MoE is the single
shard's, so its losses part from the other profiles' by the capacity drops,
in both packages alike.  The train steps differentiate through the
expert-parallel all-to-alls.  qwen3-moe trains without remat, kimi-k2 with
"dots".

The harness is tests/test_torch_sharded_step.py's: a JAX subprocess with
four host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``)
whose steps are jitted under ``make_rules(make_host_mesh(model=2),
profile)`` on parameters placed by the rules, beside four gloo ranks from
``torch.multiprocessing.spawn``, one spawn per (arch, profile), with a
``file://`` rendezvous in the test's temporary directory; every collective
has a timeout and each join is bounded, so a hang fails the test.  Each
rank gathers its results whole (``full_tensor``); rank 0's are held to the
JAX package's within fp32 2e-5 (the logits elementwise, each parameter and
moment leaf relative to its largest value) and every other rank's must
equal rank 0's.  Both archs take about 100 s together on an 8-core CPU.

    python tests/test_torch_sharded_moe_step.py --jax ARCH IN.npz OUT.npz
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
pytest.importorskip("jax")

from test_torch_sharded_step import (_jax_keyed, _params, _tree_items,  # noqa
                                     _whole, compressed_steps,
                                     jax_compressed_steps, quantized_whole,
                                     train_steps_held)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TOL = 2e-5                      # fp32 (tests/test_kernels.py:28)
ARCHS = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b")
COMPRESSED = ("qwen3-moe-235b-a22b",)   # also 2 compressed steps (float64)
PROFILES = ("default", "fsdp", "sp")
REMAT = {"qwen3-moe-235b-a22b": "none", "kimi-k2-1t-a32b": "dots"}
TRAIN_B, SERVE_B, S, MAX_LEN = 4, 2, 8, 16
DECODE_STEPS, TRAIN_STEPS = 4, 2
LR, WD, WARMUP = 1e-3, 0.01, 2  # tests/test_torch_train_step.py's
TIMEOUT_S = 420                 # each arch's spawns, from the first start


def make_inputs(arch, path):
    """JAX-initialised smoke weights (flattened to the JAX leaf keys), the
    train batch with masked labels, the serving prompt and the decode
    steps' tokens, from seeds."""
    import jax

    from repro.ckpt.shards import _flatten
    from repro.configs import get_config
    from repro.models import lm
    from repro.models.config import smoke
    cfg = smoke(get_config(arch))
    params = _flatten(lm.init_model(cfg, jax.random.key(0)))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, (TRAIN_B, S)).astype(np.int32)
    labels = tokens.copy()
    labels[1, :3] = -1
    prompt = rng.randint(0, cfg.vocab_size, (SERVE_B, S)).astype(np.int32)
    steps = rng.randint(0, cfg.vocab_size, (SERVE_B, DECODE_STEPS)).astype(
        np.int32)
    np.savez(path, tokens=tokens, labels=labels, prompt=prompt, steps=steps,
             **{f"param/{k}": v for k, v in params.items()})


# ---------------------------------------------------------------------------
# The JAX side (its own process: the four devices must exist before jax is
# imported)
# ---------------------------------------------------------------------------
def jax_side(arch, inp_path, out_path):
    import jax
    import jax.numpy as jnp

    from repro.ckpt.shards import _flatten
    from repro.configs import get_config
    from repro.launch import steps
    from repro.launch.mesh import make_host_mesh
    from repro.launch.sharding import make_rules, use_rules
    from repro.models import lm
    from repro.models.config import smoke
    from repro.models.layers import PSpec
    from repro.optim import AdamWConfig, adamw_init
    assert len(jax.devices()) == WORLD, jax.devices()
    cfg = smoke(get_config(arch))
    inp = dict(np.load(inp_path))
    flat = _params(inp)
    tree = lm.init_model(cfg, jax.random.key(0))
    leaves = [jnp.asarray(flat[k]) for k in _flatten(tree)]
    tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree),
                                        leaves)
    specs = lm.model_specs(cfg)
    batch = {"tokens": jnp.asarray(inp["tokens"]),
             "labels": jnp.asarray(inp["labels"])}
    settings = steps.TrainSettings(
        remat=REMAT[arch], opt=AdamWConfig(lr=LR, weight_decay=WD),
        warmup=WARMUP)
    mesh = make_host_mesh(model=2)
    assert mesh.devices.shape == (2, 2)

    def placed(rules, tree):
        return jax.tree_util.tree_map(
            lambda s, x: jax.device_put(x, rules.sharding(s.axes, s.shape)),
            specs, tree, is_leaf=lambda x: isinstance(x, PSpec))

    out = {}
    for profile in PROFILES:
        rules = make_rules(mesh, profile)
        params = placed(rules, tree)

        def forward(p, b):
            with use_rules(rules):
                return lm.forward(cfg, p, b)

        loss, logits = jax.jit(forward)(params, batch)
        out[f"{profile}/fwd/loss"] = np.asarray(loss)
        out[f"{profile}/fwd/logits"] = np.asarray(logits)
        logits, cache = jax.jit(steps.make_prefill_step(cfg, MAX_LEN, rules))(
            params, {"tokens": jnp.asarray(inp["prompt"])})
        out[f"{profile}/prefill/logits"] = np.asarray(logits)
        for k, v in _flatten(cache).items():
            out[f"{profile}/prefill/cache/{k}"] = v
        decode = jax.jit(steps.make_decode_step(cfg, rules))
        for i in range(DECODE_STEPS):
            logits, cache = decode(
                params, {"tokens": jnp.asarray(inp["steps"][:, i:i + 1])},
                cache, jnp.int32(S + i))
            out[f"{profile}/decode{i}/logits"] = np.asarray(logits)
        p = placed(rules, tree)
        train = jax.jit(steps.make_train_step(cfg, settings, rules))
        opt = adamw_init(p, settings.opt)
        for i in range(TRAIN_STEPS):
            p, opt, loss = train(p, opt, batch, jnp.int32(i))
            out[f"{profile}/train{i}/loss"] = np.asarray(loss)
            for k, v in _flatten({"params": p, "m": opt["m"],
                                  "v": opt["v"]}).items():
                out[f"{profile}/train{i}/{k}"] = v
    if arch in COMPRESSED:
        jax_compressed_steps(cfg, tree, lambda pr: make_rules(mesh, pr),
                             placed, batch, REMAT[arch], out)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# The torch side: one spawned process per rank
# ---------------------------------------------------------------------------
def torch_rank(rank, init, arch, profile, inp_path, out_dir):
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import make_rules, use_rules
    from repro_torch.models import smoke
    from repro_torch.optim import AdamWConfig, adamw_init
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        t0 = time.perf_counter()
        cfg = smoke(get_config(arch))
        inp = dict(np.load(inp_path))
        rules = make_rules(make_host_mesh(model=2, device_type="cpu"),
                           profile)
        model = convert.params_from_numpy(cfg, _params(inp), device="cpu",
                                          rules=rules)
        batch = {"tokens": torch.from_numpy(inp["tokens"]),
                 "labels": torch.from_numpy(inp["labels"])}
        res = {}
        with use_rules(rules), torch.no_grad():
            loss, logits = model(batch, plain=True)
        res["fwd/loss"], res["fwd/logits"] = _whole(loss), _whole(logits)
        logits, cache = steps.make_prefill_step(cfg, MAX_LEN, rules)(
            model, {"tokens": torch.from_numpy(inp["prompt"])})
        res["prefill/logits"] = _whole(logits)
        for k, v in _tree_items(cache):
            res[f"prefill/cache/{k}"] = _whole(v)
        decode = steps.make_decode_step(cfg, rules)
        for i in range(DECODE_STEPS):
            logits, cache = decode(
                model, {"tokens": torch.from_numpy(inp["steps"][:, i:i + 1])},
                cache, S + i)
            res[f"decode{i}/logits"] = _whole(logits)
        settings = steps.TrainSettings(
            remat=REMAT[arch], opt=AdamWConfig(lr=LR, weight_decay=WD),
            warmup=WARMUP)
        train = steps.make_train_step(cfg, settings, rules)
        params = dict(model.named_parameters())
        opt = adamw_init(params, settings.opt)
        for i in range(TRAIN_STEPS):
            model, opt, loss = train(model, opt, batch, i)
            res[f"train{i}/loss"] = _whole(loss)
            for part, tree in (("params", params), ("m", opt["m"]),
                               ("v", opt["v"])):
                for key, arr in _jax_keyed(cfg, tree).items():
                    res[f"train{i}/{part}/{key}"] = arr
        placements = {n: str(tuple(p.placements)) for n, p in params.items()}
        res["placements"] = np.array(sorted(placements.items()))
        if arch in COMPRESSED:
            compressed_steps(cfg, _params(inp), rules, batch, REMAT[arch],
                             res)
        res["seconds"] = np.array(time.perf_counter() - t0)
        np.savez(Path(out_dir) / f"{profile}-rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def run_arch(arch, tmp):
    """Both sides for one arch: the JAX subprocess beside the three spawns
    (one per profile).  Returns (JAX outputs, {profile: [rank outputs]})."""
    inp_path, jax_path = tmp / "inputs.npz", tmp / "jax.npz"
    make_inputs(arch, inp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT)]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    jax_proc = subprocess.Popen(
        [sys.executable, __file__, "--jax", arch, str(inp_path),
         str(jax_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for profile in PROFILES:
            ctx = torch.multiprocessing.spawn(
                torch_rank,
                args=(f"file://{tmp / ('rendezvous-' + profile)}", arch,
                      profile, str(inp_path), str(tmp)),
                nprocs=WORLD, join=False)
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    pytest.fail(f"the torch ranks of {arch} did not end "
                                f"in {TIMEOUT_S} s")
        log, _ = jax_proc.communicate(
            timeout=max(1.0, deadline - time.monotonic() + 60))
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, log
    ranks = {p: [dict(np.load(tmp / f"{p}-rank{r}.npz"))
                 for r in range(WORLD)] for p in PROFILES}
    return dict(np.load(jax_path)), ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(arch)``: each arch's two sides, run once."""
    done = {}

    def get(arch):
        if arch not in done:
            done[arch] = run_arch(arch, tmp_path_factory.mktemp(arch))
        return done[arch]
    return get


def outputs(runs, arch, profile, prefix):
    """(JAX outputs, rank 0's) under ``prefix``, keyed without it; every
    rank's outputs equal rank 0's."""
    want, ranks = runs(arch)
    got = ranks[profile]
    for r in got[1:]:
        for k in got[0]:
            if k.startswith(prefix):
                np.testing.assert_array_equal(r[k], got[0][k], err_msg=k)
    cut = len(prefix)
    return ({k[len(profile) + 1 + cut:]: v for k, v in want.items()
             if k.startswith(f"{profile}/{prefix}")},
            {k[cut:]: v for k, v in got[0].items() if k.startswith(prefix)})


def close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


CASES = [(a, p) for a in ARCHS for p in PROFILES]


@pytest.mark.parametrize("arch,profile", CASES)
def test_forward_matches_the_jax_sharded_forward(runs, arch, profile):
    want, got = outputs(runs, arch, profile, "fwd/")
    assert sorted(got) == sorted(want) == ["logits", "loss"]
    assert got["logits"].shape == (TRAIN_B, S, want["logits"].shape[-1])
    for k in want:
        close(got[k], want[k], k)


@pytest.mark.parametrize("arch,profile", CASES)
def test_prefill_matches_the_jax_sharded_prefill(runs, arch, profile):
    """The last position's logits and the whole cache (K/V of the prompt,
    zero past it)."""
    want, got = outputs(runs, arch, profile, "prefill/")
    assert sorted(got) == sorted(want) and len(want) >= 3
    for k in want:
        close(got[k], want[k], k)
        if k.startswith("cache/"):
            assert got[k].shape[2] == MAX_LEN, k
            assert not got[k][:, :, S:].any(), k


@pytest.mark.parametrize("arch,profile", CASES)
def test_decode_steps_match_the_jax_sharded_decode(runs, arch, profile):
    """Four decode steps, each against the cache the last one wrote; each
    step's 2 tokens are cut over the batch only."""
    want, got = outputs(runs, arch, profile, "decode")
    assert sorted(got) == sorted(want) == [f"{i}/logits"
                                           for i in range(DECODE_STEPS)]
    for k in want:
        close(got[k], want[k], k)


@pytest.mark.parametrize("arch,profile", CASES)
def test_train_steps_match_the_jax_sharded_train_step(runs, arch, profile):
    """The losses of both steps, and after each step every parameter and
    both moments, each leaf within 2e-5 of its largest value; step 1 moved
    every expert leaf."""
    want, got = outputs(runs, arch, profile, "train")
    assert sorted(got) == sorted(want)
    assert got["1/params/final_ln"].dtype == want[
        "1/params/final_ln"].dtype == np.float32
    for i in range(TRAIN_STEPS):
        close(got[f"{i}/loss"], want[f"{i}/loss"], f"loss {i}")
    bad = {}
    for k, w in want.items():
        if k.endswith("/loss"):
            continue
        assert got[k].shape == w.shape, k
        err = float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()),
                                                    1e-30)
        if err > TOL:
            bad[k] = err
    assert not bad, bad
    experts = [k for k in want if k.startswith("1/params/")
               and k.split("/")[-1] in ("router", "w_gate", "w_up",
                                        "w_down")]
    assert len(experts) == 4
    for k in experts:
        assert not np.array_equal(want[k], want["0" + k[1:]]), k
        assert not np.array_equal(got[k], got["0" + k[1:]]), k


COMPRESSED_CASES = [(a, p) for a in COMPRESSED for p in PROFILES]


@pytest.mark.parametrize("arch,profile", COMPRESSED_CASES)
def test_compressed_train_steps_match_the_jax_sharded_compressed_step(
        runs, arch, profile):
    """2 int8-compressed train steps in float64 through the expert-parallel
    MoE ("default", "sp") and the single shard's ("fsdp"): the losses and,
    after each step, every parameter and both moments, each leaf within
    2e-5 of its largest value."""
    want, got = outputs(runs, arch, profile, "ctrain")
    train_steps_held(got, want, np.float64)


@pytest.mark.parametrize("arch,profile", COMPRESSED_CASES)
def test_compressed_steps_quantize_each_leaf_whole(runs, arch, profile):
    """Each compressed step's codes and scales, on every rank, are the
    plain quantizer's of the whole gradient, the expert leaves' (cut on
    two mesh dims) too, and each gradient reaches AdamW placed as its
    parameter."""
    want, _ = outputs(runs, arch, profile, "ctrain")
    _, got = outputs(runs, arch, profile, "cquant")
    quantized_whole(got, sum(k.startswith("0/params/") for k in want))


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_part_from_fsdp_where_the_jax_packages_do(runs, arch):
    """"fsdp" runs the single-shard MoE (capacity from all the tokens),
    "default" and "sp" the expert-parallel one (each shard's capacity
    from its own 8 tokens): their losses part from "fsdp"'s by what the
    capacities drop, in the port by as much as in the JAX package; and
    "default" and "sp" agree."""
    want, ranks = runs(arch)
    for key in ("fwd/loss", "train0/loss", "train1/loss"):
        jax_loss = {p: float(want[f"{p}/{key}"]) for p in PROFILES}
        port = {p: float(ranks[p][0][key]) for p in PROFILES}
        for p in ("default", "sp"):
            jax_gap = jax_loss[p] - jax_loss["fsdp"]
            assert abs(jax_gap) > 1e-4, (key, p, jax_gap)
            assert port[p] - port["fsdp"] == pytest.approx(jax_gap,
                                                           abs=TOL), (key, p)
        assert port["default"] == pytest.approx(port["sp"], abs=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_leaves_are_placed_by_the_rules(runs, arch):
    """Under "default" and "sp" the expert leaves are cut on "model" over
    the experts and on "data" (ZeRO-3) over d_model; under "fsdp" on both
    mesh dims over d_model; the router is cut on "model" over the experts
    but under "fsdp"."""
    _, ranks = runs(arch)
    for profile in PROFILES:
        placed = dict(ranks[profile][0]["placements"])
        w_gate = placed["layers.0.ffn.moe.w_gate"]
        w_down = placed["layers.0.ffn.moe.w_down"]
        router = placed["layers.0.ffn.moe.router"]
        if profile == "fsdp":
            assert w_gate == "(Shard(dim=1), Shard(dim=1))", w_gate
            assert w_down == "(Shard(dim=2), Shard(dim=2))", w_down
            assert router == "(Replicate(), Replicate())", router
        else:
            assert w_gate == "(Shard(dim=1), Shard(dim=0))", (profile,
                                                              w_gate)
            assert w_down == "(Shard(dim=2), Shard(dim=0))", (profile,
                                                              w_down)
            assert router == "(Replicate(), Shard(dim=1))", (profile, router)


def test_chip_phase_11d_is_bit_for_bit_on_one_cpu_rank():
    """``chip_smoke.moe_sharded_step_phase`` (phase 11d) at smoke size on
    a one-rank gloo group: under each profile the train step (1 layer) and
    the fp32 prefill and decode steps (both layers) on DTensor parameters
    equal the plain tensors' bit for bit (one rank holds every expert, so
    the MoE is the single shard's and every collective is over a group of
    one), and the group is gone after."""
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import smoke
    out, _ = chip_smoke.moe_sharded_step_phase(
        torch, torch.device("cpu"), smoke(get_config(ARCHS[0])))
    assert not dist.is_initialized()
    assert (out["train_layers"], out["serve_layers"],
            out["serve_dtype"]) == (1, 2, "float32")
    assert sorted(out["profiles"]) == sorted(PROFILES)
    for row in out["profiles"].values():
        assert row["train"] == row["serve"] == {"exact": True,
                                                "max_abs_err": 0.0}
        assert row["loss"][0] == row["loss"][1]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
        jax_side(sys.argv[2], sys.argv[3], sys.argv[4])
