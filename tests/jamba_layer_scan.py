"""Where smoke Jamba's sharded fp32 decode parts from the JAX package's, layer
by layer (not collected by pytest).

Smoke ``jamba-v0.1-52b`` at its 2 periods (16 layers) is initialised once by
the JAX package; for each cut k, the model made of its first k layers (the
same weights, carried over by name) runs a 4 x 8 prefill and 4 decode steps
in fp32:

  * the JAX package, jitted, unsharded and under the "default" and "fsdp"
    profiles on a (2, 2) mesh of 4 host devices (a subprocess);
  * the port on plain tensors (this process), and on DTensor parameters
    under "fsdp" on 4 gloo ranks (``torch.multiprocessing.spawn``).

A cut's decode logits are the final norm and head applied to layer k's
output at that step (the cache of a layer does not depend on the layers
after it, and the decode tokens are fixed), so the table shows where along
the stack the outputs part.  It prints, for decode step 1, the largest
absolute difference of each pair.

    PYTHONPATH=src python tests/jamba_layer_scan.py OUT_DIR [K ...]
"""
import dataclasses
import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ARCH = "jamba-v0.1-52b"
B, S, MAX_LEN, STEPS = 4, 8, 16, 4
STEP = 1                        # the decode step the table reports
PAIRS = (("port fsdp", "jax fsdp"), ("jax default", "jax fsdp"),
         ("jax plain", "jax fsdp"), ("port plain", "jax plain"),
         ("port fsdp", "port plain"))


def cut(smoke, get_config, k):
    return dataclasses.replace(smoke(get_config(ARCH)), n_layers=k)


def make_inputs(path, cuts):
    """The 2-period JAX weights, each cut's leaves (by the port's parameter
    names), the prompt and the decode tokens, from seeds."""
    import jax
    import torch

    from repro.ckpt.shards import _flatten
    from repro.configs import get_config
    from repro.models import lm
    from repro.models.config import smoke
    from repro_torch import convert
    from repro_torch.configs import get_config as tget
    from repro_torch.models import LM
    from repro_torch.models import smoke as tsmoke
    cfg = smoke(get_config(ARCH))
    whole = convert.params_from_numpy(
        tsmoke(tget(ARCH)), _flatten(lm.init_model(cfg, jax.random.key(0))),
        device="cpu")
    named = dict(whole.named_parameters())
    out = {}
    for k in cuts:
        part = LM(cut(tsmoke, tget, k), device="cpu")
        with torch.no_grad():
            for n, p in part.named_parameters():
                p.copy_(named[n])
        for key, v in convert.numpy_from_params(part).items():
            out[f"k{k}/{key}"] = v
    rng = np.random.RandomState(1)
    out["tokens"] = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out["steps"] = rng.randint(0, cfg.vocab_size, (B, STEPS)).astype(
        np.int32)
    np.savez(path, cuts=np.array(cuts), **out)


def leaves(inp, k):
    pre = f"k{k}/"
    return {n[len(pre):]: inp[n] for n in inp if n.startswith(pre)}


def jax_side(inp_path, out_path):
    import math

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from repro.ckpt.shards import _flatten
    from repro.configs import get_config
    from repro.launch import steps
    from repro.launch.mesh import make_host_mesh
    from repro.launch.sharding import make_rules
    from repro.models import lm
    from repro.models.config import smoke
    from repro.models.layers import PSpec
    inp = dict(np.load(inp_path))
    mesh = make_host_mesh(model=2)
    out = {}
    for k in inp["cuts"]:
        cfg = cut(smoke, get_config, int(k))
        flat = leaves(inp, k)
        tree = lm.init_model(cfg, jax.random.key(0))
        tree = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree),
            [jnp.asarray(flat[key]) for key in _flatten(tree)])
        for profile in ("plain", "default", "fsdp"):
            rules = None if profile == "plain" else make_rules(mesh, profile)
            params = tree
            if rules is not None:
                def put(s, x):
                    spec = [e if e is None or x.shape[i] % math.prod(
                        rules.sizes[a] for a in
                        ((e,) if isinstance(e, str) else e)) == 0 else None
                        for i, e in enumerate(rules.spec(s.axes, s.shape))]
                    return jax.device_put(
                        x, NamedSharding(mesh, PartitionSpec(*spec)))
                params = jax.tree_util.tree_map(
                    put, lm.model_specs(cfg), tree,
                    is_leaf=lambda x: isinstance(x, PSpec))
            _, cache = jax.jit(steps.make_prefill_step(cfg, MAX_LEN, rules))(
                params, {"tokens": jnp.asarray(inp["tokens"])})
            decode = jax.jit(steps.make_decode_step(cfg, rules))
            for i in range(STEPS):
                logits, cache = decode(
                    params, {"tokens": jnp.asarray(inp["steps"][:, i:i + 1])},
                    cache, jnp.int32(S + i))
                out[f"jax {profile}/k{k}/decode{i}"] = np.asarray(logits)
    np.savez(out_path, **out)


def port_decode(cfg, flat, inp, rules=None):
    import torch

    from repro_torch import convert
    from repro_torch.launch import steps
    model = convert.params_from_numpy(cfg, flat, device="cpu", rules=rules)
    _, cache = steps.make_prefill_step(cfg, MAX_LEN, rules)(
        model, {"tokens": torch.from_numpy(inp["tokens"])})
    decode = steps.make_decode_step(cfg, rules)
    out = []
    for i in range(STEPS):
        logits, cache = decode(
            model, {"tokens": torch.from_numpy(inp["steps"][:, i:i + 1])},
            cache, S + i)
        if rules is not None:
            logits = logits.full_tensor()
        out.append(logits.numpy().copy())
    return out


def port_rank(rank, init, inp_path, out_path):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import make_rules
    from repro_torch.models import smoke
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    try:
        inp = dict(np.load(inp_path))
        rules = make_rules(make_host_mesh(model=2, device_type="cpu"),
                           "fsdp")
        out = {}
        for k in inp["cuts"]:
            rows = port_decode(cut(smoke, get_config, int(k)),
                               leaves(inp, k), inp, rules)
            out.update({f"port fsdp/k{k}/decode{i}": r
                        for i, r in enumerate(rows)})
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


def main(out_dir, cuts):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import smoke
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    inp_path = out / "inputs.npz"
    make_inputs(inp_path, cuts)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    jax_proc = subprocess.Popen(
        [sys.executable, __file__, "--jax", str(inp_path),
         str(out / "jax.npz")], env=env)
    torch.multiprocessing.spawn(
        port_rank, args=(f"file://{out / 'rendezvous'}", str(inp_path),
                         str(out / "port_fsdp.npz")), nprocs=4, join=True)
    inp = dict(np.load(inp_path))
    got = {}
    for k in cuts:
        rows = port_decode(cut(smoke, get_config, k), leaves(inp, k), inp)
        got.update({f"port plain/k{k}/decode{i}": r
                    for i, r in enumerate(rows)})
    if jax_proc.wait() != 0:
        raise SystemExit("the JAX side failed")
    got.update(np.load(out / "jax.npz"))
    got.update(np.load(out / "port_fsdp.npz"))
    print(f"decode step {STEP}, largest |difference| of the logits:")
    print("k | " + " | ".join(f"{a} - {b}" for a, b in PAIRS))
    for k in cuts:
        diffs = [np.abs(got[f"{a}/k{k}/decode{STEP}"]
                        - got[f"{b}/k{k}/decode{STEP}"]).max()
                 for a, b in PAIRS]
        print(f"{k} | " + " | ".join(f"{d:.3e}" for d in diffs))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        sys.path[:0] = [str(ROOT / "src")]
        jax_side(sys.argv[2], sys.argv[3])
    else:
        main(sys.argv[1], [int(k) for k in sys.argv[2:]] or
             list(range(1, 17)))
