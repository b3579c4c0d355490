"""The port's dry run against the JAX package's, on the CPU.

* ``model_flops`` equals the reference's for every config x shape.
* ``steps.input_specs`` matches the reference's structs leaf by leaf for
  every config at full width, every shape and profile, on the (2, 2) and
  (16, 16) meshes: global shape, dtype and placements against the
  reference's ``ShapeDtypeStruct`` and ``PartitionSpec``.  Parameters and
  moments are compared in the reference's layout, stacked over periods
  (``convert.jax_layout``).  The JAX side builds its ``NamedSharding``s on
  an ``AbstractMesh`` (no devices), its rules on a stand-in mesh with the
  two attributes they read; the port's side builds a DeviceMesh of the
  layout (``mesh.layout_mesh``), built over a one-rank gloo group that
  the builder destroys before it returns.
* ``make_period_body``'s arguments match the reference's, and the body's
  counted products times ``n_periods`` are the whole pass's less its
  embedding frontend and head (smoke configs of two periods).
* The cost pass's FLOPs for llama3.2-1b at full width equal the products
  counted by hand.
* ``run_cell``'s record has the reference's keys; the reference's
  ``benchmarks.roofline`` reads the port's records.
* The collectives counted from the step on DTensors: none on one device;
  on a (2, 2) layout each kind's count and bytes pinned for smoke llama,
  kimi-k2, Jamba and xLSTM under every profile, and the tensor-parallel
  all-reduces, all-to-alls and sequence gathers that the recurrent and
  MoE layers issue counted by hand.
* The layout mesh of 512 ranks builds over one rank, without the fake
  process group of ``torch.testing``.

The reference's dryrun module sets ``XLA_FLAGS`` (512 host devices) when
it is imported; the import below restores the variable at once, so the
JAX backend of this process and its subprocesses keep their own flags.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

from repro.configs import all_configs as jall_configs  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import jax_layout  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.models import LM, smoke  # noqa: E402
from repro_torch.models.config import (ALL_SHAPES, DECODE_32K,  # noqa: E402
                                       PREFILL_32K, TRAIN_4K, ShapeConfig)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(jall_configs())
SHAPES = {s.name: s for s in ALL_SHAPES}
JSHAPES = {s.name: s for s in jmc.ALL_SHAPES}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model"))}
PROFILES = ("default", "fsdp", "sp")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


@pytest.fixture
def layout():
    """``layout(name)``: (port DeviceMesh of the layout, JAX stand-in mesh,
    JAX abstract mesh); building the port's mesh leaves no process group
    behind."""
    def build(name):
        shape, names = MESHES[name]
        mesh = tmesh.layout_mesh(shape, names)
        assert not dist.is_initialized()
        return (mesh,
                types.SimpleNamespace(axis_names=names,
                                      devices=np.empty(shape, dtype=object)),
                AbstractMesh(shape, names))
    return build


def jax_rules(jmesh, amesh, profile):
    """The reference's rules whose ``sharding`` is a NamedSharding on the
    abstract mesh (the real one would need the mesh's devices)."""
    rules = jsh.make_rules(jmesh, profile)
    rules.sharding = lambda axes, shape=None: NamedSharding(
        amesh, rules.spec(axes, shape))
    return rules


def flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}{k}/"))
    return out


def entry_axes(entry):
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def check_struct(port, ref, names, key, stacked_rows=None):
    """One port struct against one reference ShapeDtypeStruct; with
    ``stacked_rows`` the reference leaf stacks that many port leaves along
    a leading unsharded dim."""
    from torch.distributed.tensor import Replicate, Shard
    spec = tuple(ref.sharding.spec)
    shape = tuple(ref.shape)
    if stacked_rows is not None:
        assert shape[0] == stacked_rows and (not spec or spec[0] is None), key
        shape, spec = shape[1:], spec[1:]
    assert tuple(port.shape) == shape, key
    assert port.dtype == DTYPES[str(ref.dtype)], key
    want = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        for a in entry_axes(entry):
            want[names.index(a)] = Shard(i)
    assert tuple(port.placements) == tuple(want), (key, spec)


def check_named(cfg, port, ref, names, what):
    """{parameter name: struct} against the reference's stacked tree."""
    ref_flat = flat(ref)
    layout = jax_layout(cfg, port)
    assert sorted(layout) == sorted(ref_flat), what
    for key, (stacked, rows) in layout.items():
        for n in rows:
            check_struct(port[n], ref_flat[key], names, f"{what}/{key}",
                         len(rows) if stacked else None)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_the_reference(arch, shape):
    assert dryrun.model_flops(get_config(arch), SHAPES[shape]) == \
        jdryrun.model_flops(jall_configs()[arch], JSHAPES[shape])


@pytest.mark.parametrize("arch", ARCHS)
def test_model_structs_are_the_models_parameters(arch):
    cfg = get_config(arch)
    want = {n: (tuple(p.shape), p.dtype) for n, p in
            LM(cfg, dtype=torch.bfloat16, device="meta").named_parameters()}
    got = {n: (tuple(t.shape), t.dtype)
           for n, t in steps.model_structs(cfg, None).items()}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(layout, arch):
    cfg, jcfg = get_config(arch), jall_configs()[arch]
    tset = steps.TrainSettings()
    jset = jsteps.TrainSettings(opt=JAdamWConfig(state_dtype=jnp.float32))
    for mesh_name in MESHES:
        mesh, jmesh, amesh = layout(mesh_name)
        names = list(MESHES[mesh_name][1])
        for profile in PROFILES:
            for shape in SHAPES:
                rules = sh.make_rules(mesh, profile)
                jrules = jax_rules(jmesh, amesh, profile)
                port = steps.input_specs(cfg, SHAPES[shape], rules, tset)
                ref = jsteps.input_specs(jcfg, JSHAPES[shape], jrules, jset)
                what = f"{mesh_name} {profile} {shape}"
                assert sorted(port) == sorted(ref), what
                check_named(cfg, port["params"], ref["params"], names,
                            f"{what} params")
                for k, v in port["batch"].items():
                    check_struct(v, ref["batch"][k], names, f"{what} {k}")
                assert sorted(port["batch"]) == sorted(ref["batch"])
                if "opt_state" in port:
                    for m in ("m", "v"):
                        check_named(cfg, port["opt_state"][m],
                                    ref["opt_state"][m], names,
                                    f"{what} {m}")
                    assert port["opt_state"]["count"] == 0
                if "cache" in port:
                    pc, rc = flat(port["cache"]), flat(ref["cache"])
                    assert sorted(pc) == sorted(rc), what
                    for k in pc:
                        check_struct(pc[k], rc[k], names, f"{what} {k}")
                # The step index and decode position: the reference's int32
                # scalars are the Python ints the port's steps take.
                for k in ("step", "pos"):
                    if k in ref:
                        assert (ref[k].shape, str(ref[k].dtype)) == \
                            ((), "int32")
                        assert isinstance(port[k], int), k
                assert rules.fallbacks == jrules.fallbacks, what


def test_batch_specs_cover_the_three_input_modes():
    seen = set()
    for arch in ARCHS:
        cfg = get_config(arch)
        seen.add(cfg.input_mode)
        for S in (1, 300):
            b = steps.batch_specs(cfg, 2, S, None, with_labels=True)
            assert tuple(b["labels"].shape) == (2, S)
            if cfg.input_mode == "mixed":
                n_patch = max(1, int(S * cfg.patch_frac)) if S > 1 else 0
                assert tuple(b["patch_embeds"].shape) == (2, n_patch,
                                                          cfg.d_model)
                assert tuple(b["tokens"].shape) == (2, S - n_patch)
    assert seen == {"tokens", "embeds", "mixed"}


@pytest.mark.parametrize("arch", ARCHS)
def test_period_body_arguments_match_the_reference(layout, arch):
    cfg, jcfg = get_config(arch), jall_configs()[arch]
    tset, jset = steps.TrainSettings(), jsteps.TrainSettings()
    mesh, jmesh, amesh = layout("16x16")
    names = list(MESHES["16x16"][1])
    for shape in SHAPES:
        body = steps.make_period_body(cfg, SHAPES[shape],
                                      sh.make_rules(mesh, "default"), tset)
        jbody = jsteps.make_period_body(jcfg, JSHAPES[shape],
                                        jax_rules(jmesh, amesh, "default"),
                                        jset)
        assert (body is None) == (jbody is None) == (cfg.n_periods <= 1)
        if body is None:
            continue
        args, jargs = body[1], jbody[1]
        assert len(args) == len(jargs)
        pl, rl = flat(args[0]), flat(jargs[0])
        assert sorted(pl) == sorted(rl)
        for k in pl:
            check_struct(pl[k], rl[k], names, f"{shape} {k}")
        for i in (1, 2):
            check_struct(args[i], jargs[i], names, f"{shape} arg {i}")
        if shape.startswith("decode") or shape == "long_500k":
            pc, rc = flat(args[3]), flat(jargs[3])
            assert sorted(pc) == sorted(rc)
            for k in pc:
                check_struct(pc[k], rc[k], names, f"{shape} cache {k}")
        elif len(args) == 4:
            assert args[3] is None and jargs[3] is None


SMOKE_BODY = [a for a in ARCHS if smoke(get_config(a)).n_periods > 1
              and smoke(get_config(a)).remainder_layers == 0]
SMALL = {"train": ShapeConfig("t", 24, 2, "train"),
         "prefill": ShapeConfig("p", 24, 2, "prefill"),
         "decode": ShapeConfig("d", 40, 2, "decode")}


def head_products(cfg, shape):
    """The products outside the layer stack: the head (every position in
    train, the last one in inference; forward 2·d·V, and in train the two
    backward products) and the embedding frontend of "embeds"/"mixed"
    (forward 2·d·d a projected input; train adds the weight gradient, the
    inputs take none)."""
    B, S, d, V = shape.global_batch, shape.seq_len, cfg.d_model, \
        cfg.padded_vocab
    S_in = 1 if shape.kind == "decode" else S
    proj = 0
    if cfg.input_mode == "embeds":
        proj = S_in
    elif cfg.input_mode == "mixed":
        proj = max(1, int(S_in * cfg.patch_frac)) if S_in > 1 else 0
    if shape.kind == "train":
        return 6 * B * S * d * V + 4 * B * proj * d * d
    return 2 * B * d * V + 2 * B * proj * d * d


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("arch", SMOKE_BODY)
def test_period_body_times_periods_is_the_layers_share(arch, kind):
    from torch.utils.flop_counter import FlopCounterMode
    cfg = smoke(get_config(arch))
    shape = SMALL[kind]
    tset = steps.TrainSettings(remat="full")
    whole = dryrun.cost_pass(cfg, shape, tset)["flops"]
    fn, args = steps.make_period_body(cfg, shape, None, tset)
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args)
    body = counter.get_total_flops()
    assert body > 0 and cfg.n_periods == 2
    assert body * cfg.n_periods == whole - head_products(cfg, shape)
    if kind == "train":
        val, (grads, gx) = out
        assert val.shape == () and tuple(gx.shape) == tuple(args[1].shape)
        assert flat(grads).keys() == flat(args[0]).keys()


def llama_products(cfg, B, S, kind, remat="none", T=None):
    """llama3.2-1b's matrix products counted by hand.  Per layer and token
    the forward projections (q, k, v, o) and the SwiGLU's three; the
    attention 4·hd·Nq per (query, key) pair over every key (the plain path
    and the chunked one compute the whole S x T grid; decode attends to
    the whole cache T); the head 2·d·V at every position in train and the
    last in prefill.  Train: the backward doubles every product; remat
    "full" recomputes each layer's forward but its last product, the FFN
    down-projection, whose output the backward does not need."""
    d, nq, nkv, hd, ff, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.hd, cfg.d_ff, cfg.padded_vocab,
                                cfg.n_layers)
    proj = 2 * d * (nq + 2 * nkv) * hd + 2 * nq * hd * d
    ffn = 3 * 2 * d * ff
    if kind == "decode":
        tokens, pairs = B, B * T
    else:
        tokens, pairs = B * S, B * S * S
    layer_fwd = L * (tokens * (proj + ffn) + pairs * 4 * hd * nq)
    head_tokens = tokens if kind == "train" else B
    fwd = layer_fwd + head_tokens * 2 * d * V
    if kind != "train":
        return fwd
    total = 3 * fwd
    if remat == "full":
        total += layer_fwd - L * tokens * 2 * ff * d
    return total


LLAMA_CASES = {
    "train_4k": (TRAIN_4K, "dots", 0),
    "train_1x4096_none": (ShapeConfig("t1", 4096, 1, "train"), "none", 0),
    "train_1x4096_full": (ShapeConfig("t1", 4096, 1, "train"), "full", 0),
    # 2 of the 16 layers: the per-layer count is the same at every depth,
    # and the chunked attention's loops on meta take about 2 s a layer.
    "prefill_32k_2_layers": (PREFILL_32K, "dots", 2),
    "decode_32k": (DECODE_32K, "dots", 0),
}


@pytest.mark.parametrize("case", list(LLAMA_CASES))
def test_llama_cost_pass_counts_the_products(case):
    shape, remat, layers = LLAMA_CASES[case]
    cfg = get_config("llama3.2-1b")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    got = dryrun.cost_pass(cfg, shape, steps.TrainSettings(remat=remat))
    want = llama_products(cfg, shape.global_batch, shape.seq_len,
                          shape.kind, remat, T=shape.seq_len)
    assert got["flops"] == want
    assert set(got["flops_by_op"]) == {"aten.mm", "aten.bmm"}
    assert got["bytes"] > 0 and got["temp_bytes"] > 0


def test_llama_train_counts_of_the_scratch_runs():
    """The counts the issue's scratch run took with FlopCounterMode."""
    cfg = get_config("llama3.2-1b")
    t1 = ShapeConfig("t1", 4096, 1, "train")
    assert llama_products(cfg, 1, 4096, "train", "none") == 36966783516672
    assert llama_products(cfg, 1, 4096, "train", "full") == 44938242818048
    assert llama_products(cfg, 128, None, "decode", T=32768) == \
        866106998784
    assert llama_products(cfg, 32, 32768, "prefill") == 6544310019293184
    assert t1.global_batch * t1.seq_len == 4096


def reference_record_keys():
    """The keys the reference's ``run_cell`` writes, read from its source
    (``src/repro/launch/dryrun.py``)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_cell")
    keys, memory = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.AnnAssign) and node.target.id == "rec":
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Subscript) and \
                node.targets[0].value.id == "rec":
            keys.add(node.targets[0].slice.value)
        if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                  "") == "update":
            keys |= {kw.arg for kw in node.keywords}
            memory |= {kw.arg for kw in next(
                kw.value for kw in node.keywords
                if kw.arg == "memory").keywords}
    return keys, memory


def test_run_cell_writes_the_reference_keys_and_both_readers_read_them(
        tmp_path, layout):
    from benchmarks import roofline as jroofline
    from repro_torch.launch import roofline
    keys, memory = reference_record_keys()
    assert {"flops_per_device", "collectives", "memory"} <= keys
    assert memory == {"argument_bytes", "output_bytes", "temp_bytes",
                      "alias_bytes"}
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                        "--mesh", "single", "--out", str(tmp_path)]) == 0
    recs = {p.name: json.loads(p.read_text())
            for p in sorted(tmp_path.glob("*.json"))}
    assert sorted(recs) == ["llama3.2-1b__decode_32k__multi.json",
                            "llama3.2-1b__decode_32k__single.json",
                            "llama3.2-1b__long_500k__single.json"]
    for name, rec in recs.items():
        if "skipped" in rec:
            assert set(rec) == {"arch", "shape", "mesh", "profile",
                                "skipped"}
            continue
        assert set(rec) == keys - {"skipped"}, name
        assert set(rec["memory"]) == memory
        assert set(rec["collectives"]) == set(dryrun.COLLECTIVES)
        assert rec["n_devices"] == (512 if "multi" in name else 256)
    single = recs["llama3.2-1b__decode_32k__single.json"]
    multi = recs["llama3.2-1b__decode_32k__multi.json"]
    assert single["flops_per_device"] == 2 * multi["flops_per_device"]
    assert single["model_flops_total"] == dryrun.model_flops(
        get_config("llama3.2-1b"), DECODE_32K)
    assert single["trip_scaled_periods"] == 15
    for reader in (jroofline, roofline):
        cells = {(c.shape, c.mesh): c for c in reader.load_cells(
            str(tmp_path))}
        assert cells[("long_500k", "single")].bottleneck == "-"
        c = cells[("decode_32k", "single")]
        assert c.compute_s > 0 and c.memory_s > 0 and c.collective_s > 0
        assert c.model_ratio == pytest.approx(
            single["model_flops_total"] / 256 / single["flops_per_device"])
        assert "decode_32k" in reader.table(str(tmp_path))


def test_main_reports_a_failing_cell(tmp_path, capsys):
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                        "--mesh", "single", "--out", str(tmp_path)]) == 1
    assert "FAIL" in capsys.readouterr().out
    rec = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert "error" in rec


def test_collectives_are_zero_on_one_device():
    """On a (1, 1) layout every collective of a step is over a group of
    one: it moves nothing and none is counted."""
    cfg = smoke(get_config("llama3.2-1b"))
    coll = dryrun.dtensor_collectives(cfg, smoke_cell("train"),
                                      steps.TrainSettings(),
                                      ((1, 1), ("data", "model")))
    assert not dist.is_initialized()
    assert all(v["bytes"] == 0 and v["count"] == 0 for v in coll.values())


def test_wire_bytes_are_the_reference_ring_factors():
    hlo = "\n".join([
        "x = bf16[1024]{0} all-gather(y), replica_groups={{0,1,2,3}}",
        "x = f32[64]{0} all-reduce(y), replica_groups=[2,8]<=[16]",
        "x = s8[256]{0} reduce-scatter(y), replica_groups={{0,1}}",
        "x = f32[32]{0} all-to-all(y), replica_groups={{0,1,2,3}}",
        "x = bf16[8]{0} collective-permute(y)"])
    ref = jdryrun.parse_collectives(hlo)
    for op, res, g in (("all-gather", 2048, 4), ("all-reduce", 256, 8),
                       ("reduce-scatter", 256, 2), ("all-to-all", 128, 4),
                       ("collective-permute", 16, 1)):
        assert dryrun.wire_bytes(op, res, g) == ref[op]["bytes"], op
    assert dryrun.DTYPE_BYTES == jdryrun.DTYPE_BYTES
    assert dryrun.COLLECTIVES == jdryrun.COLLECTIVES


def test_prefill_and_decode_steps_run_under_their_rules(layout,
                                                        monkeypatch):
    cfg = smoke(get_config("llama3.2-1b"))
    mesh, _, _ = layout("2x2")
    rules = sh.make_rules(mesh)
    seen = []
    monkeypatch.setattr(LM, "prefill", lambda self, b, n: seen.append(
        sh.current_rules()) or (None, None, 0))
    monkeypatch.setattr(LM, "decode_step", lambda self, b, c, p: seen.append(
        sh.current_rules()) or (None, c))
    model = LM(cfg, device="meta")
    steps.make_prefill_step(cfg, 8, rules)(model, {})
    steps.make_decode_step(cfg, rules)(model, {}, {}, 0)
    assert seen == [rules, rules] and sh.current_rules() is None


def test_layout_mesh_of_512_ranks_needs_no_group_of_512():
    """In a fresh interpreter: the (2, 16, 16) layout built over a one-rank
    gloo group, without the fake process group of ``torch.testing``, and
    the group gone once it is built; llama's (2048, 8192) FFN leaf under
    "fsdp" is cut to (8, 8192) on this rank."""
    code = """
import sys
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch import mesh, sharding, steps
m = mesh.make_layout_mesh(multi_pod=True)
assert tuple(m.shape) == (2, 16, 16), m.shape
assert m.mesh_dim_names == ("pod", "data", "model")
assert not dist.is_initialized()
assert tuple(m.get_coordinate()) == (0, 0, 0)
# The mesh is built without torch.testing's fake backend (DTensor itself
# imports that module once a DTensor is made, below).
assert not [k for k in sys.modules if "fake_pg" in k]
p = steps.model_structs(get_config("llama3.2-1b"),
                        sharding.make_rules(m, "fsdp"))["layers.0.ffn.w_gate"]
assert tuple(p.shape) == (2048, 8192) and p.device.type == "meta"
assert tuple(p.to_local().shape) == (8, 8192), p.to_local().shape
assert not dist.is_initialized()
print("ok")
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])})
    assert res.returncode == 0 and res.stdout.strip() == "ok", \
        res.stdout[-2000:] + res.stderr[-3000:]


# ---------------------------------------------------------------------------
# Collectives counted from the step on DTensors
# ---------------------------------------------------------------------------
# smoke(llama3.2-1b) cells on the (2, 2) layout: kind -> (batch, seq); a
# decode step runs against a cache of ``seq``.
SMOKE_CELLS = {"train": (4, 8), "prefill": (4, 8), "decode": (4, 16)}
LAYOUT_2X2 = ((2, 2), ("data", "model"))
# The port's count (``dryrun.dtensor_collectives``, TrainSettings() so
# remat "dots", bf16): kind -> (count, result bytes, wire bytes a device).
# Beside each cell, the reference's ``parse_collectives`` of the same cell
# (jax.jit of its make_*_step lowered with its input_specs on 4 XLA CPU
# devices, make_host_mesh(model=2), outer program only; printed by
# ``python tests/test_torch_dryrun.py --reference-collectives``), as
# kind: (count, result bytes).  XLA's partitioner and DTensor's choose
# their collectives each their own way, so only the port's are held.
# (With the 512 host devices that importing the reference's dryrun
# module asks for, make_host_mesh(model=2) is (256, 2) instead, and
# "fsdp" shows no collective at all: every batch and weight dim is
# below 256 and stays whole.)
PINNED_DTENSOR = {
    # ref: all-reduce (15, 177136), all-gather (23, 290944),
    # all-to-all (2, 8192), collective-permute (1, 64)
    ("default", "train"): {"all-reduce": (27, 19788, 19788.0),
                           "all-gather": (70, 426240, 213120.0),
                           "reduce-scatter": (52, 155824, 155824.0)},
    # ref: all-reduce (3, 12288), all-gather (11, 143488),
    # all-to-all (1, 4096), collective-permute (1, 64)
    ("default", "prefill"): {"all-reduce": (3, 6144, 6144.0),
                             "all-gather": (28, 217152, 108576.0),
                             "reduce-scatter": (6, 12288, 12288.0)},
    # ref: all-reduce (6, 2112), all-gather (12, 140304),
    # all-to-all (1, 512), collective-permute (1, 8)
    ("default", "decode"): {"all-reduce": (7, 1920, 1920.0),
                            "all-gather": (30, 206856, 103428.0),
                            "reduce-scatter": (6, 1536, 1536.0)},
    # ref: all-reduce (4, 279336), all-gather (16, 426112),
    # all-to-all (2, 4096)
    ("fsdp", "train"): {"all-reduce": (16, 1304, 1304.0),
                        "all-gather": (70, 614496, 307248.0),
                        "reduce-scatter": (34, 233472, 233472.0)},
    # ref: all-gather (9, 278656), all-to-all (1, 2048)
    ("fsdp", "prefill"): {"all-gather": (32, 320256, 160128.0),
                          "reduce-scatter": (2, 3072, 3072.0)},
    # ref: all-gather (9, 278544), all-to-all (1, 256)
    ("fsdp", "decode"): {"all-gather": (32, 320256, 160128.0),
                         "reduce-scatter": (2, 3072, 3072.0)},
    # ref: all-reduce (16, 186096), all-gather (35, 356480),
    # all-to-all (2, 8192), collective-permute (1, 64)
    ("sp", "train"): {"all-reduce": (23, 11596, 11596.0),
                      "all-gather": (68, 370784, 185392.0),
                      "reduce-scatter": (45, 117904, 117904.0)},
    # ref: all-reduce (5, 12808), all-gather (15, 168064),
    # all-to-all (1, 4096), collective-permute (2, 576)
    ("sp", "prefill"): {"all-reduce": (1, 2048, 2048.0),
                        "all-gather": (30, 192544, 96272.0),
                        "reduce-scatter": (6, 9216, 9216.0)},
    # ref: all-reduce (6, 2112), all-gather (12, 140304),
    # all-to-all (1, 512), collective-permute (1, 8)
    ("sp", "decode"): {"all-reduce": (7, 1920, 1920.0),
                       "all-gather": (30, 206856, 103428.0),
                       "reduce-scatter": (6, 1536, 1536.0)},
}


def smoke_cell(kind):
    B, S = SMOKE_CELLS[kind]
    return ShapeConfig(f"smoke_{kind}", S, B, kind)


@pytest.mark.parametrize("profile,kind", list(PINNED_DTENSOR))
def test_dtensor_collectives_of_smoke_llama_are_pinned(profile, kind):
    """Each kind's count, result bytes and wire bytes a device, as the
    DTensor step issues them on rank 0 of the (2, 2) layout; the pass
    leaves no process group."""
    cfg = smoke(get_config("llama3.2-1b"))
    got = dryrun.dtensor_collectives(cfg, smoke_cell(kind),
                                     steps.TrainSettings(), LAYOUT_2X2,
                                     profile)
    assert not dist.is_initialized()
    assert set(got) == set(dryrun.COLLECTIVES)
    held = {k: (v["count"], int(v["result_bytes"]), v["bytes"])
            for k, v in got.items() if v["count"]}
    assert held == PINNED_DTENSOR[profile, kind]
    assert all(v["bytes"] == 0 for v in got.values() if not v["count"])


@pytest.mark.parametrize("kind", list(SMOKE_CELLS))
def test_tensor_parallel_activation_all_reduces_are_counted(kind):
    """Under "default" each step all-reduces activations (B/2 x S x
    d_model in bf16 on this layout; one token a row in decode); under
    "fsdp" no all-reduce is of an activation: only the replicated norm
    weights' gradients (d_model in bf16) and fp32 scalars (the loss's
    sums, the gradient norm)."""
    cfg = smoke(get_config("llama3.2-1b"))
    B, S = SMOKE_CELLS[kind]
    rows = 1 if kind == "decode" else S
    activation = B // 2 * rows * cfg.d_model * 2
    calls = {p: dryrun.collective_calls(cfg, smoke_cell(kind),
                                        steps.TrainSettings(), LAYOUT_2X2,
                                        p)
             for p in ("default", "fsdp")}
    reduced = {p: [res for op, res, g in c if op == "all-reduce" and g > 1]
               for p, c in calls.items()}
    assert activation in reduced["default"]
    assert set(reduced["fsdp"]) <= {4, 2 * cfg.d_model}
    if kind != "train":
        assert not reduced["fsdp"]


def test_records_say_which_count_they_carry():
    """llama3.2-1b (attention and dense FFNs) and xlstm-125m (mLSTM and
    sLSTM layers) both carry the count of their DTensor step on the
    (16, 16) layout, with the tensor-parallel all-reduces among it.  The
    cost pass is given, so only the counts run; no process group is
    left."""
    settings = steps.TrainSettings()
    costs = {(a, "decode_32k"): {"flops": 1, "flops_by_op": {}, "bytes": 1,
                                 "temp_bytes": 1, "seconds": 0.0}
             for a in ("llama3.2-1b", "xlstm-125m")}
    recs = {a: dryrun.run_cell(a, DECODE_32K, False, settings, costs=costs)
            for a in ("llama3.2-1b", "xlstm-125m")}
    assert not dist.is_initialized()
    for arch, rec in recs.items():
        coll = rec["collectives"]
        assert {v["counted_by"] for v in coll.values()} == {"dtensor"}, arch
        assert rec["collective_bytes_per_device"] == sum(
            v["bytes"] for v in coll.values())
        assert coll["all-reduce"]["count"] > 0, arch


# smoke(kimi-k2-1t-a32b) (2 layers, each attention and an MoE FFN of 8
# experts top-2 with a shared expert) on the same cells and layout, by the
# same count.  Under "default" and "sp" the MoE is expert parallel (ep = 2
# over "model"): 2 all-to-alls a layer in prefill and decode, 4 in train
# (the backward's two; remat "dots" keeps the forward's outputs); under
# "fsdp" the expert axis is empty and the single-shard MoE gathers its
# weights, with no all-to-all.  Beside each cell, the reference's
# ``parse_collectives`` of the same cell (``--reference-collectives
# kimi-k2-1t-a32b``), as kind: (count, result bytes); only the port's are
# held.
PINNED_MOE = {
    # ref: all-reduce (17, 299124), all-gather (47, 686208),
    # all-to-all (8, 32768), collective-permute (1, 64)
    ("default", "train"): {"all-reduce": (39, 26444, 26444.0),
                           "all-gather": (92, 731392, 365696.0),
                           "reduce-scatter": (63, 215216, 215216.0),
                           "all-to-all": (8, 16384, 8192.0)},
    # ref: all-reduce (3, 12288), all-gather (22, 347776),
    # all-to-all (3, 12288), collective-permute (1, 64)
    ("default", "prefill"): {"all-reduce": (7, 6400, 6400.0),
                             "all-gather": (40, 374848, 187424.0),
                             "reduce-scatter": (8, 10240, 10240.0),
                             "all-to-all": (4, 8192, 4096.0)},
    # ref: all-reduce (7, 2128), all-gather (21, 314576),
    # all-to-all (3, 8704), collective-permute (1, 8)
    ("default", "decode"): {"all-reduce": (11, 2176, 2176.0),
                            "all-gather": (42, 364552, 182276.0),
                            "reduce-scatter": (8, 1280, 1280.0),
                            "all-to-all": (4, 8192, 4096.0)},
    # ref: all-reduce (9, 335512), all-gather (28, 348352),
    # all-to-all (9, 28672)
    ("fsdp", "train"): {"all-reduce": (16, 1304, 1304.0),
                        "all-gather": (106, 1683552, 841776.0),
                        "reduce-scatter": (34, 196608, 196608.0)},
    # ref: all-reduce (2, 41216), all-gather (14, 231552),
    # all-to-all (3, 8192)
    ("fsdp", "prefill"): {"all-gather": (48, 848640, 424320.0),
                          "reduce-scatter": (2, 3072, 3072.0)},
    # ref: all-reduce (2, 8224), all-gather (14, 229648),
    # all-to-all (3, 1024)
    ("fsdp", "decode"): {"all-gather": (48, 837888, 418944.0),
                         "reduce-scatter": (2, 3072, 3072.0)},
    # ref: all-reduce (18, 361076), all-gather (45, 706688),
    # all-to-all (19, 47232), collective-permute (1, 64)
    ("sp", "train"): {"all-reduce": (35, 18252, 18252.0),
                      "all-gather": (93, 716896, 358448.0),
                      "reduce-scatter": (55, 195728, 195728.0),
                      "all-to-all": (8, 16384, 8192.0)},
    # ref: all-reduce (5, 12808), all-gather (20, 343168),
    # all-to-all (6, 16416), collective-permute (2, 576)
    ("sp", "prefill"): {"all-reduce": (6, 4352, 4352.0),
                        "all-gather": (42, 362528, 181264.0),
                        "reduce-scatter": (6, 7168, 7168.0),
                        "all-to-all": (4, 8192, 4096.0)},
    # ref: all-reduce (7, 2128), all-gather (21, 314576),
    # all-to-all (3, 8704), collective-permute (1, 8)
    ("sp", "decode"): {"all-reduce": (11, 2176, 2176.0),
                       "all-gather": (42, 364552, 182276.0),
                       "reduce-scatter": (8, 1280, 1280.0),
                       "all-to-all": (4, 8192, 4096.0)},
}
MOE_ARCH = "kimi-k2-1t-a32b"


@pytest.mark.parametrize("profile,kind", list(PINNED_MOE))
def test_dtensor_collectives_of_smoke_kimi_are_pinned(profile, kind):
    """Each kind's count, result bytes and wire bytes a device, as the
    DTensor step of smoke kimi-k2 issues them on rank 0 of the (2, 2)
    layout, the expert-parallel all-to-alls included; the pass leaves no
    process group."""
    cfg = smoke(get_config(MOE_ARCH))
    got = dryrun.dtensor_collectives(cfg, smoke_cell(kind),
                                     steps.TrainSettings(), LAYOUT_2X2,
                                     profile)
    assert not dist.is_initialized()
    held = {k: (v["count"], int(v["result_bytes"]), v["bytes"])
            for k, v in got.items() if v["count"]}
    assert held == PINNED_MOE[profile, kind]


@pytest.mark.parametrize("profile", PROFILES)
def test_moe_all_to_alls_are_counted_per_layer(profile):
    """Every all-to-all of smoke kimi-k2's steps is the MoE's, over the
    two "model" ranks, carrying one (E, C, d_model) bf16 capacity buffer:
    2 a layer in prefill and decode and 4 in train under "default" and
    "sp", none under "fsdp"."""
    cfg = smoke(get_config(MOE_ARCH))
    n_moe = sum(cfg.is_moe_layer(li) for li in range(cfg.n_layers))
    assert n_moe == cfg.n_layers == 2
    for kind in SMOKE_CELLS:
        calls = dryrun.collective_calls(cfg, smoke_cell(kind),
                                        steps.TrainSettings(), LAYOUT_2X2,
                                        profile)
        a2a = [(res, g) for op, res, g in calls if op == "all-to-all"]
        if profile == "fsdp":
            assert a2a == [], kind
            continue
        assert len(a2a) == (4 if kind == "train" else 2) * n_moe, kind
        B, S = SMOKE_CELLS[kind]
        tokens = B * (1 if kind == "decode" else S) // 4   # a shard's
        cap = max(cfg.experts_per_token, int(
            cfg.capacity_factor * tokens * cfg.experts_per_token
            / cfg.n_experts))
        assert set(a2a) == {(cfg.n_experts * cap * cfg.d_model * 2, 2)}, \
            kind


def test_moe_records_carry_the_dtensor_count():
    """qwen3-moe-235b-a22b, kimi-k2-1t-a32b (attention and MoE FFNs) and
    jamba-v0.1-52b (mamba and attention, MoE FFNs on odd layers) carry
    the count of their DTensor step on the (16, 16) layout, with 2
    all-to-alls a MoE layer in decode.  The cost pass is given, so only
    the counts run; no process group is left."""
    settings = steps.TrainSettings()
    archs = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "jamba-v0.1-52b")
    costs = {(a, "decode_32k"): {"flops": 1, "flops_by_op": {}, "bytes": 1,
                                 "temp_bytes": 1, "seconds": 0.0}
             for a in archs}
    for arch in archs:
        cfg = get_config(arch)
        rec = dryrun.run_cell(arch, DECODE_32K, False, settings, costs=costs)
        assert not dist.is_initialized()
        coll = rec["collectives"]
        assert {v["counted_by"] for v in coll.values()} == {"dtensor"}, arch
        n_moe = sum(cfg.is_moe_layer(li) for li in range(cfg.n_layers))
        assert n_moe > 0
        assert coll["all-to-all"]["count"] == 2 * n_moe
        assert rec["collective_bytes_per_device"] == sum(
            v["bytes"] for v in coll.values())


# smoke(jamba-v0.1-52b) (16 layers: 14 mamba and 2 attention, MoE FFNs of
# 8 experts top-2 on the odd layers) and smoke(xlstm-125m) (10 mLSTM and 2
# sLSTM layers) on the same cells and layout, by the same count.  The mamba
# scans run on each rank's block of the channels ("default", "sp") or of
# the batch ("fsdp"), the mLSTM cells and the sLSTM loop on its block of
# the batch; they issue no collective of their own.  Beside each Jamba
# cell, the reference's ``parse_collectives`` of the same cell
# (``--reference-collectives jamba-v0.1-52b``), as kind: (count, result
# bytes); the reference does not lower smoke xLSTM on this layout (its
# sLSTM FFN's (64, 85) leaf does not divide over 2 "model" ranks).
PINNED_RECURRENT = {
    # ref: all-reduce (47, 1897800), all-gather (128, 3195008),
    # all-to-all (43, 188416), collective-permute (29, 114752)
    ("jamba-v0.1-52b", "default", "train"): {
        "all-reduce": (322, 312140, 312140.0),
        "all-gather": (457, 3921472, 1960736.0),
        "reduce-scatter": (344, 1219184, 1219184.0),
        "all-to-all": (32, 65536, 32768.0)},
    # ref: all-reduce (20, 62208), all-gather (58, 1450112),
    # all-to-all (9, 36864), collective-permute (15, 57408)
    ("jamba-v0.1-52b", "default", "prefill"): {
        "all-reduce": (69, 66560, 66560.0),
        "all-gather": (174, 1870336, 935168.0),
        "reduce-scatter": (46, 94208, 94208.0),
        "all-to-all": (16, 32768, 16384.0)},
    # ref: all-reduce (31, 8416), all-gather (63, 1423120),
    # all-to-all (9, 33280), collective-permute (15, 7176)
    ("jamba-v0.1-52b", "default", "decode"): {
        "all-reduce": (73, 10368, 10368.0),
        "all-gather": (176, 1723456, 861728.0),
        "reduce-scatter": (46, 11776, 11776.0),
        "all-to-all": (16, 32768, 16384.0)},
    # ref: all-reduce (21, 1823544), all-gather (113, 2475136),
    # all-to-all (33, 108544)
    ("jamba-v0.1-52b", "fsdp", "train"): {
        "all-reduce": (240, 338200, 338200.0),
        "all-gather": (398, 8429664, 4214832.0),
        "reduce-scatter": (126, 970752, 970752.0)},
    # ref: all-reduce (8, 164864), all-gather (52, 1269888),
    # all-to-all (9, 26624)
    ("jamba-v0.1-52b", "fsdp", "prefill"): {
        "all-gather": (188, 4203264, 2101632.0),
        "reduce-scatter": (2, 3072, 3072.0)},
    # ref: all-reduce (8, 32896), all-gather (52, 1262608),
    # all-to-all (9, 3328)
    ("jamba-v0.1-52b", "fsdp", "decode"): {
        "all-gather": (188, 4160256, 2080128.0),
        "reduce-scatter": (2, 3072, 3072.0)},
    # ref: all-reduce (45, 2093640), all-gather (151, 3489920),
    # all-to-all (87, 227840), collective-permute (29, 114752)
    ("jamba-v0.1-52b", "sp", "train"): {
        "all-reduce": (259, 183116, 183116.0),
        "all-gather": (444, 3709024, 1854512.0),
        "reduce-scatter": (263, 961680, 961680.0),
        "all-to-all": (32, 65536, 32768.0)},
    # ref: all-reduce (22, 62728), all-gather (68, 1499264),
    # all-to-all (21, 53376), collective-permute (16, 57920)
    ("jamba-v0.1-52b", "sp", "prefill"): {
        "all-reduce": (45, 17408, 17408.0),
        "all-gather": (180, 1697824, 848912.0),
        "reduce-scatter": (40, 58368, 58368.0),
        "all-to-all": (16, 32768, 16384.0)},
    # ref: all-reduce (31, 8416), all-gather (63, 1423120),
    # all-to-all (9, 33280), collective-permute (15, 7176)
    ("jamba-v0.1-52b", "sp", "decode"): {
        "all-reduce": (73, 10368, 10368.0),
        "all-gather": (176, 1723456, 861728.0),
        "reduce-scatter": (46, 11776, 11776.0),
        "all-to-all": (16, 32768, 16384.0)},
    ("xlstm-125m", "default", "train"): {
        "all-reduce": (174, 1653068, 1653068.0),
        "all-gather": (189, 1299392, 649696.0),
        "reduce-scatter": (106, 303024, 303024.0)},
    ("xlstm-125m", "default", "prefill"): {
        "all-reduce": (43, 272384, 272384.0),
        "all-gather": (60, 485888, 242944.0),
        "reduce-scatter": (20, 1280, 1280.0)},
    ("xlstm-125m", "default", "decode"): {
        "all-reduce": (43, 34048, 34048.0),
        "all-gather": (68, 385152, 192576.0),
        "reduce-scatter": (20, 160, 160.0)},
    ("xlstm-125m", "fsdp", "train"): {
        "all-reduce": (140, 2081560, 2081560.0),
        "all-gather": (118, 1973856, 986928.0),
        "reduce-scatter": (58, 573312, 573312.0)},
    ("xlstm-125m", "fsdp", "prefill"): {
        "all-gather": (56, 999936, 499968.0),
        "reduce-scatter": (2, 3072, 3072.0)},
    ("xlstm-125m", "fsdp", "decode"): {
        "all-gather": (56, 999936, 499968.0),
        "reduce-scatter": (2, 3072, 3072.0)},
    ("xlstm-125m", "sp", "train"): {
        "all-reduce": (150, 1537100, 1537100.0),
        "all-gather": (203, 1224192, 612096.0),
        "reduce-scatter": (108, 232816, 232816.0)},
    ("xlstm-125m", "sp", "prefill"): {
        "all-reduce": (31, 247808, 247808.0),
        "all-gather": (74, 514560, 257280.0),
        "reduce-scatter": (32, 13568, 13568.0)},
    ("xlstm-125m", "sp", "decode"): {
        "all-reduce": (43, 34048, 34048.0),
        "all-gather": (68, 385152, 192576.0),
        "reduce-scatter": (20, 160, 160.0)},
}


@pytest.mark.parametrize("arch,profile,kind", list(PINNED_RECURRENT))
def test_dtensor_collectives_of_smoke_recurrent_archs_are_pinned(
        arch, profile, kind):
    """Each kind's count, result bytes and wire bytes a device, as the
    DTensor step of smoke Jamba or xLSTM issues them on rank 0 of the
    (2, 2) layout; the pass leaves no process group."""
    cfg = smoke(get_config(arch))
    got = dryrun.dtensor_collectives(cfg, smoke_cell(kind),
                                     steps.TrainSettings(), LAYOUT_2X2,
                                     profile)
    assert not dist.is_initialized()
    held = {k: (v["count"], int(v["result_bytes"]), v["bytes"])
            for k, v in got.items() if v["count"]}
    assert held == PINNED_RECURRENT[arch, profile, kind]


@pytest.mark.parametrize("profile", PROFILES)
def test_recurrent_collectives_are_counted_by_hand(profile):
    """In the prefill, over the two "model" ranks: each mamba layer
    all-reduces its scan's b and c (B/2 x S x N in fp32; the projection
    contracts over the channels that "model" cuts), each mLSTM layer its
    q, k and v (B/2 x S x d_inner in fp32); each MoE layer of Jamba
    exchanges 2 capacity buffers (4 in train); under "sp" xLSTM gathers
    the sequence (B/2 x S x d_model in bf16) before each mLSTM layer's
    projection in and each sLSTM layer's two (the gates, the FFN).  Under
    "fsdp", which cuts no weight on "model", none of these."""
    jamba, xlstm = (smoke(get_config(a))
                    for a in ("jamba-v0.1-52b", "xlstm-125m"))
    B, S = SMOKE_CELLS["prefill"]

    seen = {}

    def calls(cfg, kind):
        if (cfg.name, kind) not in seen:
            seen[cfg.name, kind] = dryrun.collective_calls(
                cfg, smoke_cell(kind), steps.TrainSettings(), LAYOUT_2X2,
                profile)
        return seen[cfg.name, kind]

    def count(cfg, kind, op, res=None):
        return sum(1 for o, r, g in calls(cfg, kind)
                   if o == op and res in (None, r) and g == 2)

    def n(cfg, kind):
        return sum(k == kind for k in cfg.full_pattern)

    tp = profile != "fsdp"
    di = int(xlstm.mlstm_proj_factor * xlstm.d_model)
    assert count(jamba, "prefill", "all-reduce",
                 B // 2 * S * jamba.ssm_state * 4) == \
        2 * n(jamba, "mamba") * tp == 28 * tp
    assert count(xlstm, "prefill", "all-reduce", B // 2 * S * di * 4) == \
        3 * n(xlstm, "mlstm") * tp == 30 * tp
    n_moe = sum(jamba.is_moe_layer(li) for li in range(jamba.n_layers))
    for kind, per_layer in (("prefill", 2), ("train", 4)):
        assert count(jamba, kind, "all-to-all") == \
            per_layer * n_moe * tp == per_layer * 8 * tp, kind
    gathers = count(xlstm, "prefill", "all-gather",
                    B // 2 * S * xlstm.d_model * 2)
    want = n(xlstm, "mlstm") + 2 * n(xlstm, "slstm")
    assert gathers == (want if profile == "sp" else 0) and want == 14


def reference_collectives(arch="llama3.2-1b"):
    """The reference's ``parse_collectives`` of the SMOKE_CELLS of
    ``smoke(arch)``, each profile: run in a process with four host devices
    (``XLA_FLAGS``)."""
    from repro.configs import get_config as jget_config
    from repro.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=2)
    cfg = jmc.smoke(jget_config(arch))
    st = jsteps.TrainSettings()
    for profile in PROFILES:
        rules = jsh.make_rules(mesh, profile)
        for kind, (B, S) in SMOKE_CELLS.items():
            shape = jmc.ShapeConfig(f"smoke_{kind}", S, B, kind)
            sp = jsteps.input_specs(cfg, shape, rules, st)
            if kind == "train":
                fn = jsteps.make_train_step(cfg, st, rules)
                args = (sp["params"], sp["opt_state"], sp["batch"],
                        sp["step"])
            elif kind == "prefill":
                fn = jsteps.make_prefill_step(cfg, S, rules)
                args = (sp["params"], sp["batch"])
            else:
                fn = jsteps.make_decode_step(cfg, rules)
                args = (sp["params"], sp["batch"], sp["cache"], sp["pos"])
            with mesh:
                hlo = jax.jit(fn).lower(*args).compile().as_text()
            coll = jdryrun.parse_collectives(hlo)
            print(profile, kind, {k: (v["count"], v["result_bytes"])
                                  for k, v in coll.items() if v["count"]})


if __name__ == "__main__":
    # XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu
    # PYTHONPATH=src python tests/test_torch_dryrun.py --reference-collectives
    # [ARCH]      (default llama3.2-1b; kimi-k2-1t-a32b for PINNED_MOE)
    assert sys.argv[1:2] == ["--reference-collectives"] and \
        len(sys.argv) <= 3
    reference_collectives(*sys.argv[2:])
