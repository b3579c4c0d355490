"""The port's recurrent decoders on DTensor parameters against the JAX
package's sharded steps, on four CPU ranks.

For ``smoke(jamba-v0.1-52b)`` cut to one of its 2 periods (``config``:
7 mamba layers and 1 attention layer, MoE FFNs of 8 experts top-2 on odd
layers) and ``smoke(xlstm-125m)`` (2 periods of 5 mLSTM layers and 1
sLSTM layer), under each
profile of ``launch.sharding.PROFILES`` on a (2, 2) ("data", "model")
mesh, the same JAX-initialised weights (carried over by
``convert.params_from_numpy(..., rules=)``) and the same numpy batch
(4 x 8) go through

  * the training forward: its logits and loss;
  * the prefill step: its logits and cache (the mamba conv window and SSM
    state, the mLSTM C and n, the sLSTM c, n, h, m; Jamba's K/V);
  * 4 decode steps against that cache: the logits;
  * 2 train steps (lr 0 at step 0 as WSD gives it, then lr > 0): the
    losses and, after each step, every parameter and both AdamW moments;
  * for xLSTM, 2 int8-compressed train steps in float64
    (tests/test_torch_sharded_step.py's ``compressed_steps``): the same,
    and each leaf's codes and scales equal to the plain quantizer's of the
    gathered gradient on every rank.

The mamba scan runs on each rank's block of the channels (or of the
batch, under "fsdp"), the mLSTM cell on its batch block, the sLSTM loop on
its batch block with the gate inputs whole (``ops.selective_scan_on_shards``,
``ops.mlstm_on_shards``, ``blocks._slstm_on_shards``).  Under "default"
and "sp" Jamba's MoE is expert parallel (ep = 2), under "fsdp" the single
shard's, in both packages alike.  Jamba trains with remat "dots", xLSTM
with "full".

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
equal rank 0's.  The train steps run in float64 in both packages (every
fp32 cast of their model and optimizer code widened, after the fp32
parts), as tests/test_torch_train_step_f64.py holds these two archs'
unsharded steps: in fp32 their gradients and Adam's moves part by more
than 2e-5 of a leaf's largest value between any two implementations
(tests/test_torch_train_step.py's ``FP32_REPORTED``).  Both archs take
about 2 min together on an 8-core CPU.

    python tests/test_torch_sharded_recurrent_step.py --jax ARCH IN OUT
"""
import dataclasses
import datetime
import math
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
                                     train_steps_held, widen_jax,
                                     widen_torch)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TOL = 2e-5                      # fp32 (tests/test_kernels.py:28)
ARCHS = ("jamba-v0.1-52b", "xlstm-125m")
PROFILES = ("default", "fsdp", "sp")
REMAT = {"jamba-v0.1-52b": "dots", "xlstm-125m": "full"}
ALL_F64 = ("xlstm-125m",)      # every step in float64 (see above)
COMPRESSED = ("xlstm-125m",)   # also 2 compressed steps (float64)
B, S, MAX_LEN, DECODE_STEPS, TRAIN_STEPS = 4, 8, 16, 4, 2
LR, WD, WARMUP = 1e-3, 0.01, 2  # tests/test_torch_train_step.py's
TIMEOUT_S = 600                 # both archs' runs, from their start


def config(smoke, get_config, arch):
    """The smoke config of ``arch``, in either package; Jamba's cut to
    one period of its 8-layer pattern.  At the smoke config's 2 periods
    the port's "fsdp" decode missed fp32 2e-5 on 3 of 2,048 logits, by at
    most 2.27e-5, and the file took 234 s.  That is fp32 order across 16
    layers, not a wrong result: the JAX package's own "fsdp" decode parts
    from its unsharded one by 3.36e-5 there (tests/jamba_layer_scan.py
    walks the layers; PERF.md §6)."""
    cfg = smoke(get_config(arch))
    if arch == "jamba-v0.1-52b":
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    return cfg


def make_inputs(arch, path):
    """JAX-initialised smoke weights (flattened to the JAX leaf keys), a
    batch with masked labels, and the decode steps' tokens, from seeds."""
    import jax

    from repro.ckpt.shards import _flatten
    from repro.configs import get_config
    from repro.models import lm
    from repro.models.config import smoke
    cfg = config(smoke, get_config, arch)
    params = _flatten(lm.init_model(cfg, jax.random.key(0)))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = tokens.copy()
    labels[1, :3] = -1
    steps = rng.randint(0, cfg.vocab_size, (B, DECODE_STEPS)).astype(
        np.int32)
    np.savez(path, tokens=tokens, labels=labels, steps=steps,
             **{f"param/{k}": v for k, v in params.items()})


# ---------------------------------------------------------------------------
# The JAX side (its own process: the four devices must exist before jax is
# imported)
# ---------------------------------------------------------------------------
def jax_side(arch, inp_path, out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

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
    if arch in ALL_F64:
        widen_jax()
    cfg = config(smoke, get_config, arch)
    inp = dict(np.load(inp_path))
    flat = _params(inp)
    tree = lm.init_model(cfg, jax.random.key(0))
    leaves = [jnp.asarray(flat[k]) for k in _flatten(tree)]
    tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree),
                                        leaves)
    if arch in ALL_F64:
        tree = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), tree)
    specs = lm.model_specs(cfg)
    batch = {"tokens": jnp.asarray(inp["tokens"]),
             "labels": jnp.asarray(inp["labels"])}
    mesh = make_host_mesh(model=2)
    assert mesh.devices.shape == (2, 2)

    def put(rules, s, x):
        """``x`` placed as the rules say, but whole on a dim that its mesh
        axes do not divide (``device_put`` refuses such a cut; the steps'
        constraints inside ``jit`` pad it)."""
        spec = [e if e is None or x.shape[i] % math.prod(
            rules.sizes[a] for a in ((e,) if isinstance(e, str) else e))
            == 0 else None for i, e in enumerate(rules.spec(s.axes, s.shape))]
        return jax.device_put(x, NamedSharding(mesh, PartitionSpec(*spec)))

    def placed(rules, tree):
        return jax.tree_util.tree_map(
            lambda s, x: put(rules, s, x), specs, tree,
            is_leaf=lambda x: isinstance(x, PSpec))

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
            params, {"tokens": batch["tokens"]})
        out[f"{profile}/prefill/logits"] = np.asarray(logits)
        for k, v in _flatten(cache).items():
            out[f"{profile}/prefill/cache/{k}"] = v
        decode = jax.jit(steps.make_decode_step(cfg, rules))
        like = jax.tree_util.tree_map(lambda x: x.sharding, cache)
        for i in range(DECODE_STEPS):
            # Each step's cache placed as the prefill left it, so every
            # step reuses the first one's compilation.
            logits, cache = decode(
                params, {"tokens": jnp.asarray(inp["steps"][:, i:i + 1])},
                jax.tree_util.tree_map(jax.device_put, cache, like),
                jnp.int32(S + i))
            out[f"{profile}/decode{i}/logits"] = np.asarray(logits)
    widen_jax()
    tree = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), tree)
    settings = steps.TrainSettings(
        remat=REMAT[arch], opt=AdamWConfig(lr=LR, weight_decay=WD,
                                           state_dtype=jnp.float64),
        warmup=WARMUP)
    for profile in PROFILES:
        rules = make_rules(mesh, profile)
        state = (placed(rules, tree), None)
        state = (state[0], adamw_init(state[0], settings.opt))
        like = jax.tree_util.tree_map(
            lambda x: x.sharding if isinstance(x.sharding, NamedSharding)
            else NamedSharding(mesh, PartitionSpec()), state)
        train = jax.jit(steps.make_train_step(cfg, settings, rules))
        for i in range(TRAIN_STEPS):
            # Each step's state placed as the first step's, so the second
            # call reuses the first one's compilation.
            p, opt = jax.tree_util.tree_map(jax.device_put, state, like)
            p, opt, loss = train(p, opt, batch, jnp.int32(i))
            state = (p, opt)
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
def torch_rank(rank, init, arch, inp_path, out_dir):
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import make_rules, use_rules
    from repro_torch.models import smoke
    from repro_torch.models.lm import cache_specs
    from repro_torch.optim import AdamWConfig, adamw_init
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        t0 = time.perf_counter()
        cfg = config(smoke, get_config, arch)
        inp = dict(np.load(inp_path))
        mesh = make_host_mesh(model=2, device_type="cpu")
        batch = {"tokens": torch.from_numpy(inp["tokens"]),
                 "labels": torch.from_numpy(inp["labels"])}
        specs = dict(_tree_items(cache_specs(cfg, B, MAX_LEN)))
        if arch in ALL_F64:
            widen_torch()
        out = {}
        for profile in PROFILES:
            rules = make_rules(mesh, profile)
            model = convert.params_from_numpy(
                cfg, _params(inp), device="cpu", rules=rules,
                dtype=torch.float64 if arch in ALL_F64 else torch.float32)
            res = out[profile] = {}
            with use_rules(rules), torch.no_grad():
                loss, logits = model(batch, plain=True)
            res["fwd/loss"], res["fwd/logits"] = _whole(loss), _whole(logits)
            logits, cache = steps.make_prefill_step(cfg, MAX_LEN, rules)(
                model, {"tokens": batch["tokens"]})
            res["prefill/logits"] = _whole(logits)
            placed = []
            for k, v in _tree_items(cache):
                res[f"prefill/cache/{k}"] = _whole(v)
                placed.append((k, str(tuple(v.placements)), str(
                    rules.placements(specs[k].axes, specs[k].shape))))
            res["cache_placements"] = np.array(sorted(placed))
            decode = steps.make_decode_step(cfg, rules)
            for i in range(DECODE_STEPS):
                logits, cache = decode(model, {"tokens": torch.from_numpy(
                    inp["steps"][:, i:i + 1])}, cache, S + i)
                res[f"decode{i}/logits"] = _whole(logits)
        widen_torch()
        settings = steps.TrainSettings(
            remat=REMAT[arch], opt=AdamWConfig(lr=LR, weight_decay=WD,
                                               state_dtype=torch.float64),
            warmup=WARMUP)
        spec_of = steps.named_param_specs(cfg)
        for profile in PROFILES:
            rules = make_rules(mesh, profile)
            res = out[profile]
            model = convert.params_from_numpy(
                cfg, {k: v.astype(np.float64)
                      for k, v in _params(inp).items()},
                dtype=torch.float64, device="cpu", rules=rules)
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
            res["placements"] = np.array(sorted(
                (n, str(tuple(p.placements)),
                 str(rules.placements(spec_of[n].axes, spec_of[n].shape)))
                for n, p in params.items()))
            if arch in COMPRESSED:
                compressed_steps(cfg, _params(inp), rules, batch,
                                 REMAT[arch], res)
        for profile, res in out.items():
            res["seconds"] = np.array(time.perf_counter() - t0)
            np.savez(Path(out_dir) / f"{profile}-rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def start(arch, tmp):
    """Both sides of one arch, started: the JAX subprocess and one spawn of
    the four torch ranks (every profile in turn), on inputs written
    first."""
    inp_path = tmp / "inputs.npz"
    make_inputs(arch, inp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT)]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    jax_proc = subprocess.Popen(
        [sys.executable, __file__, "--jax", arch, str(inp_path),
         str(tmp / "jax.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    ranks = torch.multiprocessing.spawn(
        torch_rank, args=(f"file://{tmp / 'rendezvous'}", arch,
                          str(inp_path), str(tmp)),
        nprocs=WORLD, join=False)
    return jax_proc, ranks


def finish(arch, tmp, jax_proc, ranks, deadline):
    """Waits for both sides of one arch (each bounded by ``deadline``).
    Returns (JAX outputs, {profile: [rank outputs]})."""
    while not ranks.join(timeout=1.0):
        if time.monotonic() > deadline:
            pytest.fail(f"the torch ranks of {arch} did not end in time")
    log, _ = jax_proc.communicate(
        timeout=max(1.0, deadline - time.monotonic()))
    assert jax_proc.returncode == 0, log
    return (dict(np.load(tmp / "jax.npz")),
            {p: [dict(np.load(tmp / f"{p}-rank{r}.npz"))
                 for r in range(WORLD)] for p in PROFILES})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(arch)``: each arch's two sides, run once; both archs' sides
    all start together at the first call, and whatever still runs when the
    module ends is killed."""
    tmp = {a: tmp_path_factory.mktemp(a) for a in ARCHS}
    started, done = {}, {}

    def get(arch):
        if not started:
            started["deadline"] = time.monotonic() + TIMEOUT_S
            started.update({a: start(a, tmp[a]) for a in ARCHS})
        if arch not in done:
            done[arch] = finish(arch, tmp[arch], *started[arch],
                                started["deadline"])
        return done[arch]
    try:
        yield get
    finally:
        for a in ARCHS:
            if a in started:
                jax_proc, ranks = started[a]
                for p in [jax_proc] + list(ranks.processes):
                    if p.poll() is None if hasattr(p, "poll") \
                            else p.is_alive():
                        p.kill()


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
    assert got["logits"].shape == (B, S, want["logits"].shape[-1])
    for k in want:
        close(got[k], want[k], k)


@pytest.mark.parametrize("arch,profile", CASES)
def test_prefill_matches_the_jax_sharded_prefill(runs, arch, profile):
    """The last position's logits and the whole cache: every recurrent
    state (and Jamba's K/V, zero past the prompt)."""
    want, got = outputs(runs, arch, profile, "prefill/")
    assert sorted(got) == sorted(want) and len(want) >= 3
    for k in want:
        close(got[k], want[k], k)
        if k.endswith("/k") or k.endswith("/v"):
            assert got[k].shape[2] == MAX_LEN, k
            assert not got[k][:, :, S:].any(), k


@pytest.mark.parametrize("arch,profile", CASES)
def test_decode_steps_match_the_jax_sharded_decode(runs, arch, profile):
    """Four decode steps, each against the state the last one wrote."""
    want, got = outputs(runs, arch, profile, "decode")
    assert sorted(got) == sorted(want) == [f"{i}/logits"
                                           for i in range(DECODE_STEPS)]
    for k in want:
        close(got[k], want[k], k)


@pytest.mark.parametrize("arch,profile", CASES)
def test_train_steps_match_the_jax_sharded_train_step(runs, arch, profile):
    """The losses of both steps, and after each step every parameter and
    both moments, each leaf within 2e-5 of its largest value; step 1 moved
    every recurrent leaf that carries a gradient."""
    want, got = outputs(runs, arch, profile, "train")
    assert sorted(got) == sorted(want)
    assert got["1/params/final_ln"].dtype == want[
        "1/params/final_ln"].dtype == np.float64
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
    recurrent = [k for k in want if k.startswith("1/params/")
                 and k.split("/")[-1] in ("a_log", "conv", "w_bcdt",
                                          "r_gates", "w_if", "w_gates")]
    assert recurrent
    for k in recurrent:
        assert not np.array_equal(want[k], want["0" + k[1:]]), k
        assert not np.array_equal(got[k], got["0" + k[1:]]), k


COMPRESSED_CASES = [(a, p) for a in COMPRESSED for p in PROFILES]


@pytest.mark.parametrize("arch,profile", COMPRESSED_CASES)
def test_compressed_train_steps_match_the_jax_sharded_compressed_step(
        runs, arch, profile):
    """2 int8-compressed train steps in float64: the losses and, after
    each step, every parameter and both moments, each leaf within 2e-5 of
    its largest value."""
    want, got = outputs(runs, arch, profile, "ctrain")
    train_steps_held(got, want, np.float64)


@pytest.mark.parametrize("arch,profile", COMPRESSED_CASES)
def test_compressed_steps_quantize_each_leaf_whole(runs, arch, profile):
    """Each compressed step's codes and scales, on every rank, are the
    plain quantizer's of the whole gradient (46 of xLSTM's 48 leaves are
    stacked over the periods), and each gradient reaches AdamW placed as
    its parameter."""
    want, _ = outputs(runs, arch, profile, "ctrain")
    _, got = outputs(runs, arch, profile, "cquant")
    quantized_whole(got, sum(k.startswith("0/params/") for k in want))


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_leaves_and_caches_are_placed_by_the_rules(runs, arch):
    """Every parameter and every cache leaf of the prefill is placed as
    ``rules.placements`` of its spec says; under "default" the mamba and
    mLSTM projections in are cut on "data" (ZeRO-3) and "model", the conv
    and the SSM state on the channels over "model", the mLSTM state on
    the batch only; under "fsdp" the batch takes both mesh dims."""
    _, ranks = runs(arch)
    for profile in PROFILES:
        placed = {n: (got, want) for n, got, want in
                  ranks[profile][0]["placements"]}
        cached = {n: (got, want) for n, got, want in
                  ranks[profile][0]["cache_placements"]}
        for name, (got, want) in {**placed, **cached}.items():
            assert got == want, (profile, name)
        first = "layers.0.mixer."
        if arch.startswith("jamba"):
            seen = {n: placed[first + n][0]
                    for n in ("w_in", "conv", "a_log")}
            seen["ssm"] = cached["layers/p0/ssm"][0]
            seen["conv cache"] = cached["layers/p0/conv"][0]
            want = {"w_in": "(Shard(dim=0), Shard(dim=1))",
                    "conv": "(Replicate(), Shard(dim=1))",
                    "a_log": "(Replicate(), Shard(dim=0))",
                    "ssm": "(Shard(dim=1), Shard(dim=2))",
                    "conv cache": "(Shard(dim=1), Shard(dim=3))"}
            if profile == "fsdp":
                want = {"w_in": "(Shard(dim=0), Shard(dim=0))",
                        "conv": "(Replicate(), Replicate())",
                        "a_log": "(Replicate(), Replicate())",
                        "ssm": "(Shard(dim=1), Shard(dim=1))",
                        "conv cache": "(Shard(dim=1), Shard(dim=1))"}
        else:
            seen = {n: placed[first + n][0] for n in ("w_up", "wq")}
            seen["slstm w_gates"] = placed["layers.5.mixer.w_gates"][0]
            seen["C"] = cached["layers/p0/C"][0]
            seen["slstm c"] = cached["layers/p5/c"][0]
            want = {"w_up": "(Shard(dim=0), Shard(dim=1))",
                    "wq": "(Replicate(), Shard(dim=0))",
                    "slstm w_gates": "(Shard(dim=0), Shard(dim=1))",
                    "C": "(Shard(dim=1), Replicate())",
                    "slstm c": "(Shard(dim=1), Shard(dim=2))"}
            if profile == "fsdp":
                want = {"w_up": "(Shard(dim=0), Shard(dim=0))",
                        "wq": "(Replicate(), Replicate())",
                        "slstm w_gates": "(Shard(dim=0), Shard(dim=0))",
                        "C": "(Shard(dim=1), Shard(dim=1))",
                        "slstm c": "(Shard(dim=1), Shard(dim=1))"}
        assert seen == want, (profile, seen)


def test_chip_phase_11e_is_bit_for_bit_on_one_cpu_rank(monkeypatch):
    """``chip_smoke.recurrent_sharded_step_phase`` (phase 11e) at smoke
    size on a one-rank gloo group: for Jamba (train its first 2 layers, a
    mamba mixer with a dense FFN and one with an MoE; serve one period of
    8 layers, attention included) and xLSTM (whole, here one period of 6
    layers: 5 mLSTM and 1 sLSTM), under each profile the train step and
    the prefill and decode steps on DTensor parameters equal the plain
    tensors' bit for bit, and the group is gone after.  The phase's
    batches are cut here (train 2 x 32, serve 2 x 16 into a cache of 32):
    on the CPU the scans are the plain versions' Python loops over the
    tokens."""
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import smoke
    for name, value in (("SHARDED_TRAIN", (2, 32)), ("BATCH", 2),
                        ("PROMPT", 16), ("MAX_LEN", 32)):
        monkeypatch.setattr(chip_smoke, name, value)
    xlstm = smoke(get_config("xlstm-125m"))
    outs = chip_smoke.recurrent_sharded_step_phase(
        torch, torch.device("cpu"),
        {"jamba-v0.1-52b": smoke(get_config("jamba-v0.1-52b")),
         "xlstm-125m": dataclasses.replace(xlstm,
                                           n_layers=len(xlstm.pattern))})
    assert not dist.is_initialized()
    assert [o["arch"] for o, _ in outs] == list(ARCHS)
    (jamba, _), (xlstm, _) = outs
    assert (jamba["train_layers"], jamba["serve_layers"],
            jamba["serve_dtype"]) == (2, 8, "float32")
    assert (xlstm["train_layers"], xlstm["serve_layers"],
            xlstm["serve_dtype"]) == (6, 6, "bfloat16")
    for out, _ in outs:
        assert sorted(out["profiles"]) == sorted(PROFILES)
        for row in out["profiles"].values():
            assert row["train"] == row["serve"] == {"exact": True,
                                                    "max_abs_err": 0.0}
            assert row["loss"][0] == row["loss"][1]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
        jax_side(sys.argv[2], sys.argv[3], sys.argv[4])
