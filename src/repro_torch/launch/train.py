"""End-to-end training driver with Cornus-committed checkpointing (port of
``repro.launch.train``).

Runs a real (reduced-config or full-width) model on one device:
  data pipeline → train_step (forward + backward on the plain path, AdamW,
  WSD schedule) → every ``ckpt_every`` steps, a Cornus checkpoint epoch:
  the process acts as all ``n_hosts`` fleet members (size-balanced shard
  partitioning), votes each host's shard set into the FileStore, and the
  epoch commits iff the collective votes are durable — Algorithm 1,
  deployed.

Restart semantics: ``resume=True`` restores the newest COMMITTED epoch
(in-flight epochs are resolved by the termination protocol, never waited
on) and the stateless data pipeline replays from the restored step, so a
killed-and-restarted run produces the same loss curve as an unkilled one.
As in the reference, a resume sets the optimizer's step count to the
restored epoch.  Epochs are written in the JAX package's layout, so either
package resumes from the other's.

    python -m repro_torch.launch.train --device cpu --steps 20   # smoke
    python -m repro_torch.launch.train --full-width --batch 1 \\
        --seq-len 4096 --remat full                              # the card
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from ..ckpt import (CheckpointOutcome, CornusCheckpointer, latest_committed,
                    pack_tree, partition_leaves, restore_params)
from ..ckpt.commit import AsyncCheckpointer
from ..core.storage import FileStore
from ..data import DataConfig, Prefetcher, make_pipeline
from ..device import resolve
from ..models import config as mc
from ..models.lm import init_model
from ..optim import AdamWConfig, adamw_init
from . import steps as S


@dataclass
class RunConfig:
    arch: str = "llama3.2-1b"
    use_smoke: bool = True              # reduced config (CPU-trainable)
    steps: int = 50
    batch: int = 8
    seq_len: int = 128
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    n_hosts: int = 4                    # fleet size this process acts as
    resume: bool = False
    async_ckpt: bool = False
    data_source: str = "synthetic"
    lr: float = 1e-3
    warmup: int = 20
    seed: int = 0
    remat: str = "none"
    log_every: int = 10
    # Fault injection: kill the run (raise) right AFTER this step's vote of
    # host 0 only — leaves the epoch in-flight for restart tests.
    die_mid_checkpoint_at: Optional[int] = None
    device: str = "cuda"


@dataclass
class RunResult:
    losses: List[float] = field(default_factory=list)
    steps_done: int = 0
    restored_from: Optional[int] = None
    ckpt_outcomes: List = field(default_factory=list)
    wall_s: float = 0.0
    # Wall seconds of each step (forward, backward, update, the loss read
    # back); the checkpoints are not in them.
    step_s: List[float] = field(default_factory=list)


class MidCheckpointCrash(RuntimeError):
    """The injected crash; ``result`` holds the run up to it."""
    result: Optional[RunResult] = None


def _hosts(n: int) -> List[str]:
    return [f"host{i}" for i in range(n)]


def train(run: RunConfig) -> RunResult:
    t_start = time.time()
    dev = resolve(run.device)
    cfg = mc.smoke(_arch_cfg(run.arch)) if run.use_smoke \
        else _arch_cfg(run.arch)
    if run.data_source.startswith("bytes:"):
        assert cfg.vocab_size >= 256
    dcfg = DataConfig(batch=run.batch, seq_len=run.seq_len,
                      vocab_size=cfg.vocab_size, source=run.data_source,
                      seed=run.seed)
    pipeline = make_pipeline(dcfg)

    opt_cfg = AdamWConfig(lr=run.lr, weight_decay=0.01)
    settings = S.TrainSettings(remat=run.remat, opt=opt_cfg,
                               warmup=run.warmup, stable=10**6, decay=1)
    model = init_model(cfg, run.seed, device=dev)
    opt_state = adamw_init(dict(model.named_parameters()), opt_cfg)

    store = FileStore(run.ckpt_dir)
    hosts = _hosts(run.n_hosts)
    result = RunResult()
    start_step = 0

    if run.resume:
        epoch = latest_committed(store, hosts)
        if epoch is not None:
            restore_params(store, hosts, epoch, _state_tree(model,
                                                             opt_state))
            opt_state["count"] = epoch
            start_step = epoch
            result.restored_from = epoch

    train_step = S.make_train_step(cfg, settings)
    checkpointers = {h: CornusCheckpointer(store, h, hosts,
                                           straggler_timeout_s=10.0)
                     for h in hosts}
    async_ck = {h: AsyncCheckpointer(c) for h, c in checkpointers.items()} \
        if run.async_ckpt else None

    prefetch = Prefetcher(pipeline, start_step)
    try:
        for step in range(start_step, run.steps):
            got_step, batch = prefetch.get()
            assert got_step == step
            t0 = time.perf_counter()
            tbatch = {k: torch.from_numpy(v).to(dev)
                      for k, v in batch.items()}
            model, opt_state, loss = train_step(model, opt_state, tbatch,
                                                step)
            result.losses.append(float(loss))
            result.step_s.append(time.perf_counter() - t0)
            result.steps_done = step + 1
            if run.log_every and (step + 1) % run.log_every == 0:
                print(f"[train] step {step+1:5d} loss {float(loss):.4f}",
                      flush=True)

            if (step + 1) % run.ckpt_every == 0:
                outcome = _checkpoint(run, model, opt_state, step + 1,
                                      hosts, checkpointers, async_ck)
                if outcome is not None:
                    result.ckpt_outcomes.append(outcome)
    except MidCheckpointCrash as crash:
        crash.result = result
        raise
    finally:
        prefetch.stop()
    if async_ck:
        for h in hosts:
            result.ckpt_outcomes.extend(async_ck[h].join())
    result.wall_s = time.time() - t_start
    return result


def _state_tree(model, opt_state):
    """What a checkpoint epoch holds, keyed as the JAX package's tree."""
    return {"params": model,
            "opt": {"m": opt_state["m"], "v": opt_state["v"]}}


def _checkpoint(run, model, opt_state, epoch, hosts, checkpointers,
                async_ck):
    full = _state_tree(model, opt_state)
    parts = partition_leaves(full, len(hosts))

    if run.die_mid_checkpoint_at == epoch:
        # Crash after host0's vote only: epoch left UNDETERMINED on storage.
        checkpointers[hosts[0]].vote(epoch, pack_tree(full, parts[0]))
        raise MidCheckpointCrash(f"injected crash in epoch {epoch}")

    payloads = {h: pack_tree(full, keys) for h, keys in zip(hosts, parts)}
    if async_ck is not None:
        for h in hosts:
            async_ck[h].save(epoch, payloads[h])
        return None
    # This process acts as the whole fleet: all hosts vote first (in a real
    # deployment these are concurrent), then the collective state resolves.
    t0 = time.monotonic()
    for h in hosts:
        checkpointers[h].vote(epoch, payloads[h])
    t1 = time.monotonic()
    decision, forced = checkpointers[hosts[0]].resolve(epoch)
    return CheckpointOutcome(epoch, decision,
                             vote_ms=(t1 - t0) * 1e3,
                             resolve_ms=(time.monotonic() - t1) * 1e3,
                             forced_aborts=forced)


def _arch_cfg(arch: str):
    from ..configs import get_config
    return get_config(arch)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default=RunConfig.ckpt_dir)
    ap.add_argument("--n-hosts", type=int, default=4)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--remat", default="none",
                    choices=("none", "dots", "full"))
    ap.add_argument("--full-width", action="store_true",
                    help="the published config instead of its smoke cut")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run = RunConfig(arch=args.arch, steps=args.steps, batch=args.batch,
                    seq_len=args.seq_len, ckpt_every=args.ckpt_every,
                    ckpt_dir=args.ckpt_dir, n_hosts=args.n_hosts,
                    resume=args.resume, async_ckpt=args.async_ckpt,
                    data_source=args.data, lr=args.lr, remat=args.remat,
                    use_smoke=not args.full_width, device=args.device)
    res = train(run)
    print(f"[train] done: {res.steps_done} steps, "
          f"final loss {res.losses[-1]:.4f}, "
          f"{len(res.ckpt_outcomes)} checkpoints, {res.wall_s:.1f}s")
    return res


if __name__ == "__main__":
    main()
