"""Multi-pod dry run (port of ``repro.launch.dryrun``).

Costs every (architecture x input-shape x mesh) cell against the
production layouts, (16,16) = 256 chips single-pod and (2,16,16) = 512
chips multi-pod, and writes the roofline inputs, one JSON a cell under
--out (default artifacts/dryrun_torch), with the reference's keys:

  * FLOPs and HBM bytes.  Where the reference lowers and compiles the step
    with XLA and reads ``cost_analysis``, the port runs the step function
    once on the ``meta`` device (``cost_pass``): the model is
    ``LM(cfg, dtype=bfloat16, device="meta")`` on the plain path, its
    inputs are ``steps.input_specs``' structs at the cell's global shapes,
    and nothing is allocated or computed.
      - FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s: matrix
        products only (XLA also counts elementwise work).  Every layer and
        every attention chunk runs, so no loop body is undercounted and
        no trip-count correction applies (``trip_scaled_periods`` keeps
        the reference's number, n_periods - 1, for the record).
      - HBM bytes add, for every aten op that is not a view, its tensor
        arguments' and results' bytes (``_Traffic``): the unfused count,
        an upper bound where XLA counts each fused kernel's traffic.
    The per-device figures are the global counts over the mesh's device
    count: the ideal partition, since the port has no SPMD partitioner.
    The reference's are the partitioned program's.  The pass is the same
    for every layout of a cell, so ``main`` runs it once per arch x shape
    (``run_cell``'s ``costs``).
  * Collective wire bytes a device, with the reference's ring factors
    (``wire_bytes``), counted from the step itself for every arch
    (``dtensor_collectives``): the step runs once more on ``meta``, on
    DTensor parameters, inputs and optimizer state placed by the rules
    over ``mesh.counting_mesh`` (a process group of the layout's size
    whose collectives move nothing, started and destroyed by the pass),
    and a ``CommDebugMode`` records every functional collective that the
    step issues on rank 0, by kind, result bytes and group size: the
    weight gathers, the tensor-parallel activation all-reduces (the
    attention's and FFN's outputs, the mamba scan's b and c, the mLSTM's
    q, k and v; under "sp" reduce-scatters and the gathers of the
    sequence before each projection and each scan), the decode's merge
    over the sequence-cut cache, the expert-parallel MoE's all-to-alls (2
    a layer forward, 2 more in a train step's backward) and its aux sums,
    and the gradient reductions.  The recurrent layers' scans and the
    sLSTM's time loop run on each rank's local shards and issue none of
    their own.  Each collective kind's entry carries ``counted_by``:
    "dtensor".
  * Memory a device: ``argument_bytes`` the exact local shard bytes of the
    step's inputs from the structs' placements (this rank's, the largest
    where a dim is cut ragged), ``output_bytes`` the step's outputs placed
    as the inputs they replace (logits over batch and model),
    ``alias_bytes`` the donated inputs (params and optimizer state for
    train, the cache for decode), and ``temp_bytes`` the peak of the bytes
    of tensors made during the pass and still alive (outputs included),
    over the device count.
  * ``lower_s`` is the seconds to build the structs, ``compile_s`` the
    cost pass's seconds (shared by the layouts of a cell).

The layouts are ``mesh.make_layout_mesh``'s: DeviceMeshes of 256 and 512
ranks built over a process group of one, which the builder tears down
before it returns, since a meta pass needs no communicator.  The reference's XLA_FLAGS line (its 512 host devices) and
``auto_axis_types_kwargs`` have no counterpart.  The pass touches no
device: it runs the same on a machine with or without a card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ALIASES, get_config
from ..models.config import ALL_SHAPES, ModelConfig, ShapeConfig
from ..models.lm import LM
from ..optim import AdamWConfig
from . import steps as S
from .mesh import counting_mesh, make_layout_mesh
from .sharding import Rules, make_rules

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# The HLO element type of each torch dtype a struct can hold.
_HLO_TYPE = {torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
             torch.int16: "s16", torch.float16: "f16",
             torch.bfloat16: "bf16", torch.int32: "s32",
             torch.float32: "f32", torch.int64: "s64",
             torch.float64: "f64"}


def _bytes(numel: int, dtype: torch.dtype) -> int:
    return numel * DTYPE_BYTES[_HLO_TYPE[dtype]]


def wire_bytes(op: str, res: float, g: int) -> float:
    """Per-device wire bytes of one collective of result size ``res`` over
    a group of ``g``: the reference's ring factors
    (``parse_collectives``)."""
    g = max(g, 1)
    if op == "all-gather":
        wire = res * (g - 1) / g
    elif op == "all-reduce":
        wire = res * 2 * (g - 1) / g
    elif op == "reduce-scatter":
        wire = res * (g - 1)
    elif op == "all-to-all":
        wire = res * (g - 1) / g
    else:  # collective-permute
        wire = res
    return wire


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Hand-derived 'useful' FLOPs: 6·N_active·D train, 2·N_active·D infer."""
    n = cfg.active_param_count() - cfg.padded_vocab * cfg.d_model  # non-embed
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        base = 6.0 * n * tokens
        # logits matmul fwd+bwd
        base += 6.0 * shape.global_batch * shape.seq_len * \
            cfg.d_model * cfg.padded_vocab
        return base
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens + 2.0 * tokens * cfg.d_model * cfg.padded_vocab
    # decode: one token/seq against cache (attention adds 2·S·d per kv layer)
    tokens = shape.global_batch
    flops = 2.0 * n * tokens + 2.0 * tokens * cfg.d_model * cfg.padded_vocab
    n_attn = sum(1 for k in cfg.full_pattern if k.startswith("attn"))
    flops += (4.0 * cfg.n_kv_heads * cfg.hd * shape.seq_len
              * cfg.n_heads // max(cfg.n_kv_heads, 1)) * n_attn * tokens
    return flops


# ---------------------------------------------------------------------------
# The cost pass
# ---------------------------------------------------------------------------
def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _Traffic(TorchDispatchMode):
    """Bytes each aten op reads and writes, and the live bytes of the
    tensors made under the mode.  A view op moves nothing and is skipped;
    every other op adds each tensor argument's and result's elements times
    their size (``bytes``).  A result whose storage is new joins the live
    set until its storage is freed (a finalizer on the storage's Python
    object, which torch keeps while the storage lives); ``peak`` is the
    most the live set held.  ``exclude`` marks the pass's inputs, which
    are not the pass's to count."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakSet()
        self._finalizers = []

    def exclude(self, tree):
        for t in _tensors(tree):
            self._seen.add(t.untyped_storage())

    def _free(self, n: int):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        results = _tensors(out)
        if not func.is_view:
            self.bytes += sum(_bytes(t.numel(), t.dtype)
                              for t in _tensors((args, kwargs)) + results)
        for t in results:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._finalizers.append(weakref.finalize(st, self._free, n))
        return out

    def __exit__(self, *exc):
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()
        return super().__exit__(*exc)


def step_specs(cfg: ModelConfig, shape: ShapeConfig,
               settings: "S.TrainSettings", dtype: torch.dtype) -> Dict:
    """``input_specs`` without rules for a model in ``dtype``: a decode
    cache in ``dtype`` (its recurrent states fp32), as ``LM.prefill``
    makes it for such a model."""
    specs = S.input_specs(cfg, shape, None, settings)
    if "cache" in specs:
        specs["cache"] = S.cache_structs(cfg, shape.global_batch,
                                         shape.seq_len, None, dtype)
    return specs


def step_call(cfg: ModelConfig, shape: ShapeConfig,
              settings: "S.TrainSettings", specs: Dict, model: LM,
              rules: Optional[Rules] = None):
    """(fn, args): the step of this shape's kind on ``model``, under
    ``rules``, with ``specs`` (``input_specs``, or tensors of their
    shapes) as its inputs."""
    if shape.kind == "train":
        fn = S.make_train_step(cfg, settings, rules)
        args = (model, specs["opt_state"], specs["batch"], specs["step"])
    elif shape.kind == "prefill":
        fn = S.make_prefill_step(cfg, shape.seq_len, rules)
        args = (model, specs["batch"])
    else:
        fn = S.make_decode_step(cfg, rules)
        args = (model, specs["batch"], specs["cache"], specs["pos"])
    return fn, args


def cost_pass(cfg: ModelConfig, shape: ShapeConfig,
              settings: "S.TrainSettings",
              dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The step run once on ``meta`` at the cell's global shapes: its
    products' FLOPs (``FlopCounterMode``), by aten op too; the unfused
    HBM bytes and the peak of live bytes (``_Traffic``); and the seconds
    the pass took.  The model's parameters are ``dtype`` (the structs',
    bf16, for the dry run's cells), on the plain path."""
    specs = step_specs(cfg, shape, settings, dtype)
    model = LM(cfg, dtype=dtype, device="meta")
    model.plain_kernels = True
    fn, args = step_call(cfg, shape, settings, specs, model)
    counter = FlopCounterMode(display=False)
    traffic = _Traffic()
    traffic.exclude((list(model.parameters()), args[1:]))
    t0 = time.perf_counter()
    with counter, traffic:
        fn(*args)
    seconds = time.perf_counter() - t0
    by_op = {str(k): int(v) for k, v in
             counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(counter.get_total_flops()), "flops_by_op": by_op,
            "bytes": int(traffic.bytes), "temp_bytes": int(traffic.peak),
            "seconds": seconds}


# ---------------------------------------------------------------------------
# Collectives counted from the step on DTensors
# ---------------------------------------------------------------------------
def _count_mode():
    """A ``CommDebugMode`` that also keeps, for each functional collective
    it sees, (kind, result bytes, group size)."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    f = torch.ops._c10d_functional
    kinds = {f.all_reduce: "all-reduce",
             f.all_gather_into_tensor: "all-gather",
             f.reduce_scatter_tensor: "reduce-scatter",
             f.all_to_all_single: "all-to-all"}

    class Count(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            kind = kinds.get(getattr(func, "_overloadpacket", None))
            if kind is not None and out is not NotImplemented:
                group = dist.distributed_c10d._resolve_process_group(
                    args[-1])
                self.calls.append((kind, _bytes(out.numel(), out.dtype),
                                   group.size()))
            return out

    return Count()


def collective_calls(cfg: ModelConfig, shape: ShapeConfig,
                     settings: "S.TrainSettings", layout: tuple,
                     profile: str = "default",
                     dtype: torch.dtype = torch.bfloat16) -> list:
    """The collectives of one step on rank 0 of the ``layout`` ((shape,
    names) of the mesh), in order, as (kind, result bytes, group size):
    the step runs on ``meta`` on an ``LM(..., rules=)`` of ``dtype``
    DTensors and ``input_specs``' structs, all placed by
    ``make_rules(mesh, profile)`` over ``mesh.counting_mesh(*layout)``,
    whose group this pass starts and destroys.  Every collective the step
    issues must be one of the four kinds read here."""
    with counting_mesh(*layout) as mesh:
        rules = make_rules(mesh, profile)
        specs = S.input_specs(cfg, shape, rules, settings)
        model = LM(cfg, dtype=dtype, device="meta", rules=rules)
        model.plain_kernels = True
        fn, args = step_call(cfg, shape, settings, specs, model, rules)
        with _count_mode() as mode:
            fn(*args)
    seen = mode.get_total_counts()
    if seen != len(mode.calls):
        raise RuntimeError(f"{seen - len(mode.calls)} collectives of "
                           f"another kind than {COLLECTIVES[:4]}: "
                           f"{dict(mode.get_comm_counts())}")
    return mode.calls


def dtensor_collectives(cfg: ModelConfig, shape: ShapeConfig,
                        settings: "S.TrainSettings", layout: tuple,
                        profile: str = "default",
                        dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Per-device collective bytes and counts of one step, by the
    reference's keys, from ``collective_calls``.  A group of one moves
    nothing and is not counted."""
    out = {c: {"bytes": 0.0, "count": 0, "result_bytes": 0.0}
           for c in COLLECTIVES}
    for kind, res, g in collective_calls(cfg, shape, settings, layout,
                                         profile, dtype):
        if g > 1:
            out[kind]["bytes"] += wire_bytes(kind, res, g)
            out[kind]["count"] += 1
            out[kind]["result_bytes"] += res
    return out


# ---------------------------------------------------------------------------
# Memory and collectives from the structs' placements
# ---------------------------------------------------------------------------
def local_bytes(tree) -> int:
    """Bytes of this rank's shards of a struct tree (a plain tensor whole;
    Python ints count as the reference's int32 scalars)."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, int):
            total += DTYPE_BYTES["s32"]
            continue
        local = t.to_local() if hasattr(t, "to_local") else t
        total += _bytes(local.numel(), local.dtype)
    return total


def _outputs(cfg: ModelConfig, shape: ShapeConfig, specs: Dict,
             rules: Rules) -> int:
    """Local bytes of the step's outputs: the updated state placed as its
    inputs, the logits (bf16, last position) over batch and model, the
    loss an fp32 scalar."""
    B = shape.global_batch
    if shape.kind == "train":
        return local_bytes((specs["params"], specs["opt_state"])) + 4
    logits = S._struct((B, 1, cfg.padded_vocab), torch.bfloat16, rules,
                       ("batch", None, "model"))
    cache = specs["cache"] if shape.kind == "decode" else \
        S.cache_structs(cfg, B, shape.seq_len, rules)
    return local_bytes((logits, cache))


def run_cell(arch: str, shape: ShapeConfig, multi_pod: bool,
             settings: "S.TrainSettings", profile: str = "default", *,
             costs: Optional[Dict] = None) -> Dict:
    """One cell's record, with the reference's keys.  ``costs`` keeps each
    arch x shape's ``cost_pass`` for the other layout of the cell."""
    cfg = get_config(arch)
    mesh_name = "multi" if multi_pod else "single"
    rec: Dict = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                 "profile": profile}
    if shape.name == "long_500k" and not cfg.subquadratic:
        rec["skipped"] = ("full-attention arch: 512k context needs "
                          "sub-quadratic attention (DESIGN §5)")
        return rec

    mesh = make_layout_mesh(multi_pod=multi_pod)
    n_dev = mesh.size()
    rules = make_rules(mesh, profile)
    t0 = time.time()
    specs = S.input_specs(cfg, shape, rules, settings)
    t1 = time.time()
    costs = {} if costs is None else costs
    if (arch, shape.name) not in costs:
        costs[arch, shape.name] = cost_pass(cfg, shape, settings)
    cost = costs[arch, shape.name]

    args = {"train": ("params", "opt_state", "batch", "step"),
            "prefill": ("params", "batch"),
            "decode": ("params", "batch", "cache", "pos")}[shape.kind]
    donated = {"train": ("params", "opt_state"), "prefill": (),
               "decode": ("cache",)}[shape.kind]
    coll = dtensor_collectives(
        cfg, shape, settings,
        (tuple(mesh.shape), tuple(mesh.mesh_dim_names)), profile)
    for entry in coll.values():
        entry["counted_by"] = "dtensor"
    trips = cfg.n_periods - 1 if cfg.n_periods > 1 else 0

    rec.update(
        n_devices=n_dev,
        lower_s=round(t1 - t0, 2),
        compile_s=round(cost["seconds"], 2),
        flops_per_device=cost["flops"] / n_dev,
        hbm_bytes_per_device=cost["bytes"] / n_dev,
        collectives=coll,
        collective_bytes_per_device=sum(v["bytes"] for v in coll.values()),
        memory=dict(
            argument_bytes=local_bytes([specs[k] for k in args]),
            output_bytes=_outputs(cfg, shape, specs, rules),
            temp_bytes=cost["temp_bytes"] / n_dev,
            alias_bytes=local_bytes([specs[k] for k in donated]),
        ),
        params_total=cfg.param_count(),
        params_active=cfg.active_param_count(),
        model_flops_total=model_flops(cfg, shape),
        trip_scaled_periods=trips,
        sharding_fallbacks=len(rules.fallbacks),
    )
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help="arch id (dash form) or 'all'")
    ap.add_argument("--shape", default="all",
                    help="train_4k|prefill_32k|decode_32k|long_500k|all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--remat", default="dots",
                    choices=["none", "dots", "full"])
    ap.add_argument("--opt-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--profile", default="default",
                    choices=["default", "fsdp", "sp"])
    args = ap.parse_args(argv)

    settings = S.TrainSettings(
        remat=args.remat,
        opt=AdamWConfig(state_dtype=torch.bfloat16 if args.opt_dtype ==
                        "bfloat16" else torch.float32))

    archs = list(ALIASES) if args.arch == "all" else [args.arch]
    shapes = [s for s in ALL_SHAPES
              if args.shape in ("all", s.name)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    costs: Dict = {}
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                mesh_name = "multi" if multi else "single"
                tag = f"{arch}__{shape.name}__{mesh_name}"
                path = os.path.join(args.out, tag + ".json")
                try:
                    rec = run_cell(arch, shape, multi, settings,
                                   args.profile, costs=costs)
                except Exception as e:  # a dry-run failure is a real bug
                    rec = {"arch": arch, "shape": shape.name,
                           "mesh": mesh_name, "error": repr(e)[:2000]}
                    failures.append(tag)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = ("SKIP" if "skipped" in rec else
                          "FAIL" if "error" in rec else
                          f"ok {rec['compile_s']:6.1f}s "
                          f"flops/dev={rec['flops_per_device']:.3e} "
                          f"coll/dev={rec['collective_bytes_per_device']:.3e}")
                print(f"[dryrun] {tag:55s} {status}", flush=True)
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES: {failures}")
        return 1
    print("[dryrun] all cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
