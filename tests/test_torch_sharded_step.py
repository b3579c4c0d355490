"""The port's steps on DTensor parameters against the JAX package's sharded
steps, on four CPU ranks.

For ``smoke(llama3.2-1b)`` and ``smoke(gemma2-2b)`` (local windows, both
softcaps, post-norms), under each profile of ``launch.sharding.PROFILES``
("default", "fsdp", "sp") on a (2, 2) ("data", "model") mesh, the same
JAX-initialised weights (carried over by ``convert.params_from_numpy(...,
rules=)``) and the same numpy batch go through

  * the training forward: its logits and loss;
  * the prefill step (``make_prefill_step``): its logits and cache;
  * 4 decode steps (``make_decode_step``) against that cache: the logits;
  * 2 train steps (``make_train_step``, lr 0 at step 0 as WSD gives it,
    then lr > 0): the losses and, after each step, every parameter and
    both AdamW moments;
  * 2 int8-compressed train steps (``TrainSettings(compress=
    CompressionConfig())``) in float64, from the same weights: the same,
    and on every rank the codes and scales of each JAX leaf, which must
    equal bit for bit the plain ``compress_gradients`` of the gradient
    gathered whole (a rank-local max would part from them), and the
    placements of the gradients handed to AdamW, which must be their
    parameters'.  In fp32 a gradient's rounding can move a code across a
    ``.5`` boundary, and Adam turns that into a move of about lr.

The JAX side runs in a subprocess with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), its steps jitted
under ``make_rules(make_host_mesh(model=2), profile)`` with the parameters
placed by the rules; it writes its outputs to an npz.  The torch side is
four gloo ranks from ``torch.multiprocessing.spawn``, one spawn per
(arch, profile), with a ``file://`` rendezvous in the test's temporary
directory; every collective has a timeout and each join is bounded, so a
hang fails the test.  Both sides run at once.  Each rank gathers its
results whole (``full_tensor``); rank 0's are held to the JAX package's
and every other rank's must equal rank 0's.

Everything is held within 2e-5 (tests/test_kernels.py:28-29): the logits
elementwise (absolute and relative), each parameter and moment leaf
relative to its largest value, as tests/test_torch_train_step.py holds
the unsharded step.  Everything runs in fp32 but gemma2's train steps,
which run in float64 in both packages (every fp32 cast of their model and
optimizer code widened, ``widen_torch`` / ``widen_jax``, after the fp32
parts), as tests/test_torch_train_step_f64.py holds the conditioned
steps: in fp32 the JAX package's own sharded steps part by 1.8e-5
("fsdp") and 4.6e-5 ("sp") of the leaf's largest value from its
"default" one in gemma2's ``layers/p1/mixer/wo`` after the step with
lr > 0, where an element's gradient is about 1e-9, near its rounding, and
Adam moves it by a fraction of lr whatever its size.  llama trains
without remat, gemma2 with "dots".  Both archs take about 2 min together
on an 8-core CPU (the six spawns run one after another, the two JAX
subprocesses beside them).

    python tests/test_torch_sharded_step.py --jax ARCH IN.npz OUT.npz
"""
import dataclasses
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

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TOL = 2e-5                      # fp32 (tests/test_kernels.py:28)
ARCHS = ("llama3.2-1b", "gemma2-2b")
PROFILES = ("default", "fsdp", "sp")
REMAT = {"llama3.2-1b": "none", "gemma2-2b": "dots"}
TRAIN_F64 = ("gemma2-2b",)       # train steps in float64 (see above)
B, S, MAX_LEN, DECODE_STEPS, TRAIN_STEPS = 4, 8, 16, 4, 2
LR, WD, WARMUP = 1e-3, 0.01, 2  # tests/test_torch_train_step.py's
TIMEOUT_S = 420                 # each arch's spawns, from the first start


def make_inputs(arch, path):
    """JAX-initialised smoke weights (flattened to the JAX leaf keys), a
    batch with masked labels, and the decode steps' tokens, from seeds."""
    import jax

    from repro.ckpt.shards import _flatten
    from repro.configs import get_config
    from repro.models import lm
    from repro.models.config import smoke
    cfg = smoke(get_config(arch))
    params = _flatten(lm.init_model(cfg, jax.random.key(0)))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = tokens.copy()
    labels[1, :3] = -1
    steps = rng.randint(0, cfg.vocab_size, (B, DECODE_STEPS)).astype(
        np.int32)
    np.savez(path, tokens=tokens, labels=labels, steps=steps,
             **{f"param/{k}": v for k, v in params.items()})


def _params(inp):
    return {k[len("param/"):]: inp[k] for k in inp if k.startswith("param/")}


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
    keys = list(_flatten(tree))
    leaves = [jnp.asarray(flat[k]) for k in keys]
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
            params, {"tokens": batch["tokens"]})
        out[f"{profile}/prefill/logits"] = np.asarray(logits)
        for k, v in _flatten(cache).items():
            out[f"{profile}/prefill/cache/{k}"] = v
        decode = jax.jit(steps.make_decode_step(cfg, rules))
        for i in range(DECODE_STEPS):
            logits, cache = decode(
                params, {"tokens": jnp.asarray(inp["steps"][:, i:i + 1])},
                cache, jnp.int32(S + i))
            out[f"{profile}/decode{i}/logits"] = np.asarray(logits)
    if arch in TRAIN_F64:
        widen_jax()
        tree = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), tree)
        settings = dataclasses.replace(settings, opt=dataclasses.replace(
            settings.opt, state_dtype=jnp.float64))
    for profile in PROFILES:
        rules = make_rules(mesh, profile)
        p = placed(rules, tree)
        train = jax.jit(steps.make_train_step(cfg, settings, rules))
        opt = adamw_init(p, settings.opt)
        for i in range(TRAIN_STEPS):
            p, opt, loss = train(p, opt, batch, jnp.int32(i))
            out[f"{profile}/train{i}/loss"] = np.asarray(loss)
            for k, v in _flatten({"params": p, "m": opt["m"],
                                  "v": opt["v"]}).items():
                out[f"{profile}/train{i}/{k}"] = v
    jax_compressed_steps(cfg, tree, lambda pr: make_rules(mesh, pr), placed,
                         batch, REMAT[arch], out)
    np.savez(out_path, **out)


def jax_compressed_steps(cfg, tree, rules_of, placed, batch, remat, out):
    """The JAX half of the compressed steps: under each profile, 2 jitted
    int8-compressed train steps (``TrainSettings(compress=
    CompressionConfig())``, step indices 0 and 1) from ``tree`` in float64
    (``widen_jax``), with ``placed(rules, tree)`` putting the parameters
    where the rules say.  Each step's state is placed as the first step's
    was, so the second call reuses the first one's compilation.  Writes
    ``{profile}/ctrain{i}/...`` into ``out``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from repro.ckpt.shards import _flatten
    from repro.launch import steps
    from repro.optim import AdamWConfig, CompressionConfig, adamw_init
    widen_jax()
    tree = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), tree)
    settings = steps.TrainSettings(
        remat=remat, opt=AdamWConfig(lr=LR, weight_decay=WD,
                                     state_dtype=jnp.float64),
        warmup=WARMUP, compress=CompressionConfig())
    for profile in PROFILES:
        rules = rules_of(profile)
        p = placed(rules, tree)
        state = (p, adamw_init(p, settings.opt))
        like = jax.tree_util.tree_map(
            lambda x: x.sharding if isinstance(x.sharding, NamedSharding)
            else NamedSharding(rules.mesh, PartitionSpec()), state)
        train = jax.jit(steps.make_train_step(cfg, settings, rules))
        for i in range(TRAIN_STEPS):
            p, opt = jax.tree_util.tree_map(jax.device_put, state, like)
            p, opt, loss = train(p, opt, batch, jnp.int32(i))
            state = (p, opt)
            out[f"{profile}/ctrain{i}/loss"] = np.asarray(loss)
            for k, v in _flatten({"params": p, "m": opt["m"],
                                  "v": opt["v"]}).items():
                out[f"{profile}/ctrain{i}/{k}"] = v


def widen_jax():
    """Every fp32 cast of the JAX package's model and optimizer code
    becomes float64 (tests/test_torch_train_step.py's
    ``widen_fp32_casts``)."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64


def widen_torch():
    """Every fp32 cast of the port's model and optimizer code
    (``.float()``, ``torch.float32``) becomes float64 (the torch half of
    tests/test_torch_train_step.py's ``widen_fp32_casts``)."""
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda self: self.double()

    class Torch64:
        def __getattr__(self, name):
            return torch.float64 if name == "float32" else getattr(torch,
                                                                   name)

    from repro_torch.kernels import ref
    from repro_torch.models import blocks, layers, moe
    from repro_torch.optim import adamw, compress, schedules
    for mod in (blocks, layers, moe, ref, adamw, compress, schedules):
        mod.torch = Torch64()
    # The rope frequencies are cached per (hd, theta, device): an fp32
    # table that an earlier fp32 run left there would stay fp32.
    layers._rope_freqs_on.cache_clear()


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
            model, {"tokens": batch["tokens"]})
        res["prefill/logits"] = _whole(logits)
        for k, v in _tree_items(cache):
            res[f"prefill/cache/{k}"] = _whole(v)
        decode = steps.make_decode_step(cfg, rules)
        for i in range(DECODE_STEPS):
            logits, cache = decode(
                model, {"tokens": torch.from_numpy(inp["steps"][:, i:i + 1])},
                cache, S + i)
            res[f"decode{i}/logits"] = _whole(logits)
        dtype = torch.float32
        if arch in TRAIN_F64:
            widen_torch()
            dtype = torch.float64
            model = convert.params_from_numpy(
                cfg, {k: v.astype(np.float64)
                      for k, v in _params(inp).items()},
                dtype=dtype, device="cpu", rules=rules)
        settings = steps.TrainSettings(
            remat=REMAT[arch], opt=AdamWConfig(lr=LR, weight_decay=WD,
                                               state_dtype=dtype),
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
        compressed_steps(cfg, _params(inp), rules, batch, REMAT[arch], res)
        res["seconds"] = np.array(time.perf_counter() - t0)
        np.savez(Path(out_dir) / f"{profile}-rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def compressed_steps(cfg, flat, rules, batch, remat, res):
    """The torch half of the compressed steps, on one rank: 2
    int8-compressed train steps (step indices 0 and 1) on DTensor
    parameters placed by ``rules``, from the JAX weights ``flat`` in
    float64 (``widen_torch``), each under ``chip_smoke.CompressRecorder``.
    Writes into ``res`` the loss and every parameter and moment after each
    step (``ctrain{i}/...``, gathered whole), and what was quantized
    (``cquant{i}/...``): each JAX leaf's scale, the
    ``chip_smoke.compression_failures`` of the rows of
    ``compression_rows`` (the recorded codes and scale, gathered whole,
    against the plain ``compress_gradients`` of the gradient gathered
    whole), how many leaves were quantized as DTensors, and the gradients
    handed to AdamW that were not placed as their parameters."""
    import chip_smoke
    from repro_torch import convert
    from repro_torch.convert import jax_layout
    from repro_torch.launch import steps
    from repro_torch.launch.sharding import is_dtensor
    from repro_torch.optim import AdamWConfig, CompressionConfig, adamw_init
    widen_torch()
    ccfg = CompressionConfig()
    settings = steps.TrainSettings(
        remat=remat, opt=AdamWConfig(lr=LR, weight_decay=WD,
                                     state_dtype=torch.float64),
        warmup=WARMUP, compress=ccfg)
    model = convert.params_from_numpy(
        cfg, {k: v.astype(np.float64) for k, v in flat.items()},
        dtype=torch.float64, device="cpu", rules=rules)
    train = steps.make_train_step(cfg, settings, rules)
    params = dict(model.named_parameters())
    opt = adamw_init(params, settings.opt)
    for i in range(TRAIN_STEPS):
        with chip_smoke.CompressRecorder() as rec:
            model, opt, loss = train(model, opt, batch, i)
        res[f"ctrain{i}/loss"] = _whole(loss)
        for part, tree in (("params", params), ("m", opt["m"]),
                           ("v", opt["v"])):
            for key, arr in _jax_keyed(cfg, tree).items():
                res[f"ctrain{i}/{part}/{key}"] = arr
        rows = chip_smoke.compression_rows(cfg, rec.grads, rec.codes, ccfg)
        res[f"cquant{i}/scales"] = np.array([r["scale"] for r in rows])
        res[f"cquant{i}/failures"] = np.array(chip_smoke.compression_failures(
            rows, list(jax_layout(cfg, rec.grads))), dtype=str)
        res[f"cquant{i}/dtensor_leaves"] = np.array(sum(
            is_dtensor(q) and is_dtensor(s) for q, s in rec.codes.values()))
        res[f"cquant{i}/misplaced"] = np.array(rec.misplaced, dtype=str)


def _whole(t):
    """A copy of the DTensor's global value (``full_tensor`` of a
    replicated DTensor is its local tensor, which a later step updates in
    place)."""
    return t.full_tensor().detach().numpy().copy()


def _tree_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _jax_keyed(cfg, tree):
    """{parameter name: DTensor} gathered whole and stacked under the JAX
    leaf keys (``convert.jax_layout``)."""
    from repro_torch.convert import jax_layout
    out = {}
    for key, (stacked, names) in jax_layout(cfg, tree).items():
        rows = [_whole(tree[n]) for n in names]
        out[key] = np.stack(rows) if stacked else rows[0]
    return out


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
    assert got["logits"].shape == (B, S, want["logits"].shape[-1])
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
    """Four decode steps, each against the cache the last one wrote (on
    "default" the cache is cut on its sequence over "model", so the
    steps merge each rank's partial attention)."""
    want, got = outputs(runs, arch, profile, "decode")
    assert sorted(got) == sorted(want) == [f"{i}/logits"
                                           for i in range(DECODE_STEPS)]
    for k in want:
        close(got[k], want[k], k)


@pytest.mark.parametrize("arch,profile", CASES)
def test_train_steps_match_the_jax_sharded_train_step(runs, arch, profile):
    """The losses of both steps, and after each step every parameter and
    both moments, each leaf within 2e-5 of its largest value."""
    want, got = outputs(runs, arch, profile, "train")
    train_steps_held(got, want,
                     np.float64 if arch in TRAIN_F64 else np.float32)


def train_steps_held(got, want, dtype):
    """The losses of the train steps, and after each step every parameter
    and both moments, each leaf within 2e-5 of its largest value; step 1
    (lr > 0) moved the parameters."""
    assert sorted(got) == sorted(want)
    assert got["1/params/final_ln"].dtype == want[
        "1/params/final_ln"].dtype == dtype
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
    moved = [k for k in want if k.startswith("1/params/")
             and not np.array_equal(want[k], want["0" + k[1:]])]
    assert moved


def quantized_whole(got, n_leaves):
    """What ``compressed_steps`` recorded of each step's quantization (one
    rank's; the caller holds every rank's to rank 0's): each of the
    ``n_leaves`` JAX leaves was quantized once, as DTensors, into the codes
    and scale that the plain ``compress_gradients`` makes of the gradient
    gathered whole, bit for bit, its error within half its scale; and each
    gradient reached AdamW placed as its parameter."""
    for i in range(TRAIN_STEPS):
        assert got[f"{i}/scales"].shape == (n_leaves,)
        assert got[f"{i}/failures"].size == 0, got[f"{i}/failures"]
        assert int(got[f"{i}/dtensor_leaves"]) == n_leaves
        assert got[f"{i}/misplaced"].size == 0, got[f"{i}/misplaced"]
        assert (got[f"{i}/scales"] > 0).all()


@pytest.mark.parametrize("arch,profile", CASES)
def test_compressed_train_steps_match_the_jax_sharded_compressed_step(
        runs, arch, profile):
    """2 int8-compressed train steps in float64 (``TrainSettings(compress=
    CompressionConfig())``): the losses and, after each step, every
    parameter and both moments, as the uncompressed steps are held."""
    want, got = outputs(runs, arch, profile, "ctrain")
    train_steps_held(got, want, np.float64)


@pytest.mark.parametrize("arch,profile", CASES)
def test_compressed_steps_quantize_each_leaf_whole(runs, arch, profile):
    """Each compressed step's codes and scales, on every rank, are the
    plain quantizer's of the whole gradient (a rank-local max would part
    from them), and each gradient reaches AdamW placed as its
    parameter."""
    want, _ = outputs(runs, arch, profile, "ctrain")
    _, got = outputs(runs, arch, profile, "cquant")
    quantized_whole(got, sum(k.startswith("0/params/") for k in want))


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_are_placed_by_the_rules(runs, arch):
    """Under "default" the attention and FFN weights are cut on "data"
    (ZeRO-3) and "model"; under "fsdp" on both mesh dims of one tensor
    dim; the norms are whole everywhere."""
    _, ranks = runs(arch)
    for profile in PROFILES:
        placed = dict(ranks[profile][0]["placements"])
        wq = placed["layers.0.mixer.wq"]
        norm = placed["layers.0.mixer.ln"]
        assert norm == "(Replicate(), Replicate())", (profile, norm)
        if profile == "fsdp":
            assert wq == "(Shard(dim=0), Shard(dim=0))", wq
        else:
            assert wq == "(Shard(dim=0), Shard(dim=1))", (profile, wq)


def test_chip_phase_11c_is_bit_for_bit_on_one_cpu_rank():
    """``chip_smoke.sharded_step_phase`` (phase 11c, with its compressed
    half) at smoke size on a one-rank gloo group: under each profile the
    train step, the int8-compressed train step, the prefill and the
    decode steps on DTensor parameters equal the plain tensors' bit for
    bit (every collective is over a group of one), the compressed step's
    codes and scales equal the plain compressed step's for every JAX
    leaf, and the group is gone after."""
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import smoke
    out, _ = chip_smoke.sharded_step_phase(
        torch, torch.device("cpu"), smoke(get_config("llama3.2-1b")),
        compress=True)
    assert not dist.is_initialized()
    assert sorted(out["profiles"]) == sorted(PROFILES)
    assert out["plain"]["leaves"] == 11     # 9 stacked over the periods
    for row in out["profiles"].values():
        assert row["train"] == row["serve"] == row["compressed_train"] == {
            "exact": True, "max_abs_err": 0.0}
        assert row["loss"][0] == row["loss"][1]
        assert row["compressed_loss"][0] == row["compressed_loss"][1]
        assert row["codes"] == {"leaves": 11, "equal": 11}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
        jax_side(sys.argv[2], sys.argv[3], sys.argv[4])
