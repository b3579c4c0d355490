"""The port's sharding rules and meshes against the JAX package's, on the CPU.

Every leaf of every config's parameter specs (stacked over periods, as the
JAX package lays them out) and cache specs (at DECODE_32K's batch and
length, and LONG_500K's batch of 1, where the cache's seq dim takes both
axes) goes through both packages' ``make_rules`` under the profiles
default, fsdp and sp, on the meshes (16, 16), (2, 16, 16), (2, 2) and
(1, 4).  The port's spec entries must equal the reference's
``PartitionSpec`` entries, its fallbacks the reference's, its DTensor
placements the ones those entries name, and each leaf's local shard
``dim // product`` wherever the axes divide the dim (the leaves they do
not divide are printed: GSPMD pads those, DTensor leaves short shards).

The JAX side reads only ``mesh.axis_names`` and ``mesh.devices.shape``
(``repro/launch/sharding.py:45-88``), so a stand-in with those two
attributes serves the large meshes.  The port's side builds a real
``DeviceMesh`` of 4, 256 or 512 ranks in this process over the fake
backend of ``torch.testing`` (rank 0 of a world of which no other rank
exists); each test destroys its group.
"""
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import torch.distributed as dist  # noqa: E402

from repro.configs import all_configs as jall_configs  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import (DECODE_32K, LONG_500K, cache_specs,  # noqa
                                init_model, model_specs, smoke)
from repro_torch.models.layers import (PSpec, param_shardings,  # noqa: E402
                                       param_structs, stack_specs)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
PROFILES = ("default", "fsdp", "sp")
ARCHS = sorted(jall_configs())


@pytest.fixture
def fake_world():
    """``world(n)``: a fake process group of n ranks (this process is rank
    0), destroyed when the test ends."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def world(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)

    try:
        yield world
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def device_mesh(world, name):
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = MESHES[name]
    world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def jax_mesh(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def stacked_specs(cfg):
    """The port's parameter specs in the JAX package's layout: the layers
    of pattern position p under ``layers/p{p}``, stacked over periods by
    ``stack_specs``, then ``rem{r}``."""
    specs = model_specs(cfg)
    per_layer = specs.pop("layers")
    period = len(cfg.pattern)
    if cfg.n_periods:
        specs["layers"] = {f"p{p}": stack_specs(per_layer[p], cfg.n_periods)
                           for p in range(period)}
    for r in range(cfg.remainder_layers):
        specs[f"rem{r}"] = per_layer[cfg.n_periods * period + r]
    return specs


def flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}{k}/"))
    return out


def all_leaves(cfg, jcfg):
    """{key: (port PSpec, JAX PSpec)} over the model and both decode
    shapes' caches, keys sorted."""
    port = {f"params/{k}": v for k, v in flat(stacked_specs(cfg)).items()}
    ref = {f"params/{k}": v for k, v in flat(jlm.model_specs(jcfg)).items()}
    for shape in (DECODE_32K, LONG_500K):
        b, t = shape.global_batch, shape.seq_len
        port.update({f"{shape.name}/{k}": v for k, v in
                     flat(cache_specs(cfg, b, t)).items()})
        ref.update({f"{shape.name}/{k}": v for k, v in
                    flat(jlm.cache_specs(jcfg, b, t)).items()})
    assert sorted(port) == sorted(ref)
    return {k: (port[k], ref[k]) for k in sorted(port)}


def entry_axes(entry):
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_specs_match_the_reference(fake_world, mesh_name, profile, arch):
    from torch.distributed.tensor import Replicate, Shard
    cfg, jcfg = get_config(arch), jall_configs()[arch]
    mesh = device_mesh(fake_world, mesh_name)
    names = list(MESHES[mesh_name][1])
    rules = sh.make_rules(mesh, profile)
    jrules = jsh.make_rules(jax_mesh(mesh_name), profile)
    assert rules.logical == jrules.logical
    assert rules.sizes == jrules.sizes

    leaves = all_leaves(cfg, jcfg)
    specs = {}
    for key, (spec, jspec) in leaves.items():
        assert (spec.shape, spec.axes) == (tuple(jspec.shape),
                                           tuple(jspec.axes)), key
        specs[key] = rules.spec(spec.axes, spec.shape)
        assert specs[key] == tuple(jrules.spec(jspec.axes, jspec.shape)), key
        assert rules.spec(spec.axes) == tuple(jrules.spec(jspec.axes)), key
        for entry in specs[key]:        # DTensor's order is the mesh's
            dims = [names.index(a) for a in entry_axes(entry)]
            assert dims == sorted(dims), (key, entry)
    assert rules.fallbacks == jrules.fallbacks

    # Placements: Shard(i) on the mesh dims the entry of dim i names.
    tree = {k: s for k, (s, _) in leaves.items()}
    placed = param_shardings(tree, sh.make_rules(mesh, profile))
    structs = param_structs(tree, sh.make_rules(mesh, profile))
    uneven = []
    for key, spec in tree.items():
        want = [Replicate()] * len(names)
        for i, entry in enumerate(specs[key]):
            for a in entry_axes(entry):
                want[names.index(a)] = Shard(i)
        assert placed[key] == tuple(want), key
        st = structs[key]
        assert st.device.type == "meta" and tuple(st.shape) == spec.shape
        assert tuple(st.placements) == tuple(want), key
        local = tuple(st.to_local().shape)
        for i, dim in enumerate(spec.shape):
            entry = specs[key][i] if i < len(specs[key]) else None
            n = math.prod(rules.sizes[a] for a in entry_axes(entry))
            if dim % n == 0:
                assert local[i] == dim // n, (key, i, local)
            else:
                uneven.append((key, i, dim, n, local[i]))
    print(f"{mesh_name} {profile} {arch}: {len(tree)} leaves, "
          f"{len(rules.fallbacks)} fallbacks, uneven {json.dumps(uneven)}")


def test_placements_refuse_axes_out_of_mesh_order(fake_world):
    """A tuple that lists mesh axes against the mesh's order has no DTensor
    placement that cuts the dim as JAX would; the spec itself still equals
    the reference's."""
    mesh = device_mesh(fake_world, "2x2")
    logical = {"fsdp": ("model", "data")}
    rules = sh.Rules(mesh, logical=dict(logical))
    jrules = jsh.Rules(jax_mesh("2x2"), logical=dict(logical))
    assert rules.spec(("fsdp", None), (8, 4)) == \
        tuple(jrules.spec(("fsdp", None), (8, 4))) == (("model", "data"),)
    with pytest.raises(ValueError, match="mesh's order"):
        rules.placements(("fsdp", None), (8, 4))


def test_make_rules_drops_pod_without_a_pod_axis(fake_world):
    mesh = device_mesh(fake_world, "2x2")
    assert sh.make_rules(mesh, "fsdp").logical["batch"] == \
        jsh.make_rules(jax_mesh("2x2"), "fsdp").logical["batch"] == \
        ("data", "model")


def test_make_rules_keeps_pod_on_the_multi_pod_mesh(fake_world):
    mesh = device_mesh(fake_world, "2x16x16")
    assert sh.make_rules(mesh, "fsdp").logical["batch"] == \
        jsh.make_rules(jax_mesh("2x16x16"), "fsdp").logical["batch"] == \
        ("pod", "data", "model")
    assert sh.make_rules(mesh).axis_size("batch") == 32


def test_constrain_redistributes_a_dtensor_and_passes_the_rest(fake_world):
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    mesh = device_mesh(fake_world, "2x2")
    x = torch.arange(32.0).reshape(8, 4)
    assert sh.constrain(x, ("fsdp", None)) is x          # no active rules
    rules = sh.make_rules(mesh)
    dx = DTensor.from_local(x, mesh, [Replicate(), Replicate()],
                            run_check=False)
    with sh.use_rules(rules):
        assert sh.current_rules() is rules
        assert sh.constrain(x, ("fsdp", None)) is x      # a plain tensor
        out = sh.constrain(dx, ("fsdp", None))
        cut = sh.constrain(distribute_tensor(x, mesh, [Replicate(),
                                                       Replicate()]),
                           ("fsdp", "model"))
    assert sh.current_rules() is None
    # Replicate -> Shard cuts locally: rank 0 keeps the first rows.
    assert tuple(out.placements) == (Shard(0), Replicate())
    torch.testing.assert_close(out.to_local(), x[:4], rtol=0, atol=0)
    assert tuple(cut.placements) == (Shard(0), Shard(1))
    torch.testing.assert_close(cut.to_local(), x[:4, :2], rtol=0, atol=0)


def test_train_step_under_rules_on_plain_tensors_is_the_step(fake_world):
    """With rules active, the compressed step's int8 leaves pass
    ``constrain`` unchanged when they are plain tensors: the same step as
    without rules, bit for bit (llama: no MoE, so nothing else reads the
    rules)."""
    from repro_torch.optim import AdamWConfig, CompressionConfig, adamw_init
    cfg = smoke(get_config("llama3.2-1b"))
    tset = steps.TrainSettings(remat="none", opt=AdamWConfig(lr=1e-3),
                               compress=CompressionConfig(), warmup=2)
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 16)))
    b = {"tokens": toks, "labels": toks}
    mesh = device_mesh(fake_world, "2x2")
    out = []
    for rules in (None, sh.make_rules(mesh, "fsdp")):
        model = init_model(cfg, 0, device="cpu")
        opt = adamw_init(dict(model.named_parameters()), tset.opt)
        _, opt, loss = steps.make_train_step(cfg, tset, rules)(model, opt,
                                                               b, 1)
        out.append((float(loss), {n: p.detach().clone()
                                  for n, p in model.named_parameters()}))
    assert out[0][0] == out[1][0]
    for n, p in out[0][1].items():
        assert torch.equal(out[1][1][n], p), n


# -- the expert-parallel MoE refuses rules that share batch and expert ------
OVERLAP_T = {"T16": (2, 8), "T8": (2, 4), "T5": (1, 5)}


def jax_overlap_outcomes():
    """The reference's moe_apply under rules with batch over (data, model)
    on a (1, 4) mesh of host devices, in a subprocess: {case: the name of
    the exception raised, or "ran"}."""
    code = f"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import get_config
from repro.launch.mesh import auto_axis_types_kwargs
from repro.launch.sharding import Rules, use_rules
from repro.models import config as mc, moe
from repro.models.layers import init_params
cfg = mc.smoke(get_config("kimi-k2-1t-a32b"))
mesh = jax.make_mesh((1, 4), ("data", "model"), **auto_axis_types_kwargs(2))
rules = Rules(mesh, logical={{"batch": ("data", "model")}})
p = init_params(moe.moe_specs(cfg), jax.random.key(0))
out = {{}}
for name, shape in {OVERLAP_T!r}.items():
    x = jax.random.normal(jax.random.key(1), tuple(shape) + (cfg.d_model,))
    try:
        with use_rules(rules):
            jax.block_until_ready(moe.moe_apply(cfg, p, x))
        out[name] = "ran"
    except Exception as e:
        out[name] = type(e).__name__
print(json.dumps(out))
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": os.pathsep.join(
                 [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])})
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_moe_refuses_batch_and_expert_on_one_mesh_dim(fake_world):
    """The port raises ValueError for every token count.  The reference's
    shard map fails only where the tokens are cut over batch and expert
    together (T = 16 = dp·ep: a spec naming "model" twice raises
    ``DuplicateSpecError``); at T = 8 (over batch only, which now includes
    "model") and T = 5 (replicated) it runs."""
    from repro_torch.models.moe import moe_apply, moe_specs
    assert jax_overlap_outcomes() == {"T16": "DuplicateSpecError",
                                      "T8": "ran", "T5": "ran"}
    cfg = smoke(get_config("kimi-k2-1t-a32b"))
    mesh = device_mesh(fake_world, "1x4")
    rules = sh.Rules(mesh, logical={"batch": ("data", "model")})
    assert rules.axis_size("expert") == 4 and cfg.n_experts % 4 == 0
    gen = torch.Generator().manual_seed(0)
    params = {n: torch.randn(s.shape, generator=gen) * s.stddev()
              for n, s in moe_specs(cfg).items()}
    for shape in OVERLAP_T.values():
        x = torch.randn(*shape, cfg.d_model, generator=gen)
        with torch.no_grad(), sh.use_rules(rules), \
                pytest.raises(ValueError, match="needs them apart"):
            moe_apply(cfg, params, x)
    # None of the profiles shares a mesh dim between the two.
    for profile in PROFILES:
        r = sh.make_rules(mesh, profile)
        assert not set(r.logical["batch"]) & set(r.logical["expert"])


# -- meshes ------------------------------------------------------------------
def test_production_mesh(fake_world):
    fake_world(256)
    m = tmesh.make_production_mesh(device_type="cpu")
    assert tuple(m.shape) == (16, 16)
    assert m.mesh_dim_names == ("data", "model")
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")


def test_multi_pod_production_mesh(fake_world):
    fake_world(512)
    m = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert tuple(m.shape) == (2, 16, 16)
    assert m.mesh_dim_names == ("pod", "data", "model")


@pytest.mark.parametrize("model,shape", [(1, (4, 1)), (2, (2, 2)),
                                         (4, (1, 4))])
def test_host_mesh(fake_world, model, shape):
    fake_world(4)
    m = tmesh.make_host_mesh(model, device_type="cpu")
    assert tuple(m.shape) == shape and m.mesh_dim_names == ("data", "model")


def test_host_mesh_refuses_a_model_axis_that_does_not_divide(fake_world):
    fake_world(4)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_host_mesh(3, device_type="cpu")


def test_meshes_need_an_initialized_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="none is initialized"):
        tmesh.make_host_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="none is initialized"):
        tmesh.make_production_mesh(device_type="cpu")


def test_meshes_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_production_mesh()


def test_param_structs_without_rules_are_meta_tensors():
    specs = {"w": PSpec((4, 6), ("fsdp", "model")),
             "s": [PSpec((3,), (None,), dtype=torch.float32)]}
    out = param_structs(specs, None)
    assert out["w"].device.type == "meta" and out["w"].shape == (4, 6)
    assert out["w"].dtype == torch.bfloat16
    assert out["s"][0].dtype == torch.float32


def test_param_structs_cut_a_dim_the_axes_do_not_divide(fake_world):
    """10 rows over a model axis of 4: DTensor's ``Shard`` gives rank 0
    ceil(10 / 4) = 3 rows (the last rank 1), where GSPMD would pad to 12."""
    mesh = device_mesh(fake_world, "1x4")
    rules = sh.make_rules(mesh)
    st = param_structs({"w": PSpec((10, 6), ("model", None))}, rules,
                       dtype=torch.float32)["w"]
    assert tuple(st.shape) == (10, 6) and st.dtype == torch.float32
    assert tuple(st.to_local().shape) == (3, 6)
