"""One training step of the port against the JAX package, on the CPU.

The same JAX-initialized weights (carried over by ``repro_torch.convert``)
and the same batch go through the JAX train step's pieces and the port's,
on the llama, xLSTM and Jamba smoke configs (Jamba's loss carries its
routers' aux term): the loss, every gradient leaf, and after the update the
parameters and both moments, at step 0 (WSD gives lr 0) and at step 1
(lr > 0).  Each leaf is held within 2e-5 of its largest value, the repo's
fp32 kernel tolerance (tests/test_kernels.py:28).

In fp32 the xLSTM smoke model's gradients move by about 6e-5 of their
largest value under rounding-level noise (JAX jitted against JAX eager
differ by 6.2e-5; each package against a float64 run by 2.5e-5 to 3.6e-5),
so no two fp32 implementations meet 2e-5 there.  Its fp32 step is held in
the loss and its leaves' errors are printed (``FP32_REPORTED``);
``tests/test_torch_train_step_f64.py`` runs this file's steps in float64
in both packages (``--float64``), where every part is held at 2e-5.

The int8-compressed step (``TrainSettings.compress``): a gradient that
differs by its fp32 rounding between the packages can land on the other
side of a code's ``.5`` boundary, and Adam turns that flip into a move of
about lr.  So the whole compressed step of both packages'
``make_train_step`` is held in float64 (``--float64 ARCH --compress``, run
by ``tests/test_torch_train_step_f64.py``), and in fp32 the compression and
the update are held from the JAX gradients carried over, where the codes
must be equal.
"""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.shards import _flatten as jflatten  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.ckpt.shards import _flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import init_model, smoke  # noqa: E402
from repro_torch.optim import (AdamWConfig, CompressionConfig,  # noqa: E402
                               adamw_init, adamw_update, compress_gradients,
                               wsd_schedule)

REL = 2e-5
ARCHS = ["llama3.2-1b", "xlstm-125m", "jamba-v0.1-52b"]
COMPRESS_ARCHS = ["llama3.2-1b", "jamba-v0.1-52b", "gemma2-2b", "xlstm-125m"]
# Parts of the fp32 step that are conditioned beyond REL, reported with
# their numbers instead of held: every part of xLSTM's (see above), and
# Jamba's parameters and second moment after the first step with lr > 0.
# Adam moves each element by about lr whatever its gradient's size, so an
# element whose gradient is near its rounding noise (the norm and SSM
# leaves, zero or small at init) differs by a fraction of lr between the
# packages; v squares the gradients' 1.5e-5, to 2.0e-5 in ``w_dt``.
FP32_REPORTED = {("xlstm-125m", "*"), ("jamba-v0.1-52b", "params@1"),
                 ("jamba-v0.1-52b", "opt/v@1")}
LR, WD, WARMUP = 1e-3, 0.01, 2          # the trainer's AdamW and warm-up


def batch(cfg, seed=0, B=2, S=16):
    """A training batch with the keys of ``cfg.input_mode``: tokens; frame
    embeddings; or patch embeddings (a quarter of the sequence, none at
    S = 1, as ``batch_specs`` splits it) before tokens.  Labels span the
    sequence."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[1, :3] = -1                                  # masked labels
    if cfg.input_mode == "tokens":
        return {"tokens": toks, "labels": labels}
    if cfg.input_mode == "embeds":
        return {"frame_embeds": rng.randn(B, S, cfg.d_model).astype(
            np.float32), "labels": labels}
    n_patch = max(1, int(S * cfg.patch_frac)) if S > 1 else 0
    return {"patch_embeds": rng.randn(B, n_patch, cfg.d_model).astype(
        np.float32), "tokens": toks[:, n_patch:], "labels": labels}


def worst_leaf(got, want):
    """{key: |got - want| max / |want| max} over the JAX keys."""
    assert sorted(got) == sorted(want)
    out = {}
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = np.asarray(got[k], np.float32)
        assert g.shape == w.shape, k
        out[k] = float(np.abs(g - w).max()) / max(float(np.abs(w).max()),
                                                  1e-30)
    return out


def held(got, want, what, hold=True):
    errs = worst_leaf(got, want)
    bad = {k: e for k, e in errs.items() if e > REL}
    assert not (hold and bad), \
        f"{what}: leaves beyond {REL} of their largest value: {bad}"
    return max(errs.values())


def jax_keyed(model, tensors):
    """Tensors keyed by the model's parameter names, under the JAX keys."""
    flat = _flatten({"params": model, "x": tensors})
    return {k[2:]: v for k, v in flat.items() if k.startswith("x/")}


def settings(remat="none", dtype=torch.float32, compress=False):
    """The trainer's settings in both packages, moments in ``dtype``; with
    ``compress``, int8 gradient compression in both."""
    jdtype = np.float64 if dtype == torch.float64 else np.float32
    jset = jsteps.TrainSettings(remat="none", opt=jadamw.AdamWConfig(
        lr=LR, weight_decay=WD, state_dtype=jdtype), warmup=WARMUP,
        stable=10**6, decay=1,
        compress=jcompress.CompressionConfig() if compress else None)
    tset = steps.TrainSettings(remat=remat, opt=AdamWConfig(
        lr=LR, weight_decay=WD, state_dtype=dtype), warmup=WARMUP,
        stable=10**6, decay=1,
        compress=CompressionConfig() if compress else None)
    return jset, tset


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = jmc.smoke(jget_config(arch))
    cfg = smoke(get_config(arch))
    jparams = jlm.init_model(jcfg, jax.random.key(0))
    return arch, jcfg, cfg, jparams


def jax_step(jcfg, jset):
    """The JAX train step's pieces (``steps.make_train_step``), jitted once:
    (params, opt, batch, step) -> (loss, grads, new params, new opt)."""
    @jax.jit
    def run(params, opt, b, step):
        loss, grads = jax.value_and_grad(
            lambda p: jlm.forward(jcfg, p, b, remat="none")[0])(params)
        lr_scale = jsteps.wsd_schedule(step, warmup=jset.warmup,
                                       stable=jset.stable, decay=jset.decay)
        new_p, new_opt = jadamw.adamw_update(grads, opt, params, jset.opt,
                                             lr_scale)
        return loss, grads, new_p, new_opt

    return run


def step_errors(arch, jcfg, cfg, jparams, dtype=torch.float32,
                steps_at=(0, 1)):
    """Steps of each package from the same weights, at the step indices
    ``steps_at`` in turn; the largest relative error of each part, held at
    REL unless FP32_REPORTED names the part."""

    def hold(part):
        return dtype == torch.float64 or not (
            (arch, "*") in FP32_REPORTED or (arch, part) in FP32_REPORTED)

    jset, tset = settings(dtype=dtype)
    model = convert.params_from_numpy(cfg, jflatten(jparams), dtype=dtype,
                                      device="cpu")
    opt = adamw_init(dict(model.named_parameters()), tset.opt)
    jopt = jadamw.adamw_init(jparams, jset.opt)
    train_step = steps.make_train_step(cfg, tset)
    jrun = jax_step(jcfg, jset)
    report = {}
    for step in steps_at:
        nb = batch(cfg, seed=step)
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        tb = {k: torch.from_numpy(v) for k, v in nb.items()}
        jloss, jgrads, jparams, jopt = jrun(jparams, jopt, jb,
                                            jnp.asarray(step, jnp.int32))
        loss, grads = steps.loss_and_grads(model, tb)
        assert abs(float(loss) - float(jloss)) <= REL * abs(float(jloss))
        assert grads["embed"].dtype == dtype
        assert opt["m"]["embed"].dtype == dtype
        report[f"loss@{step}"] = abs(float(loss) - float(jloss)) / abs(
            float(jloss))
        report[f"grads@{step}"] = held(jax_keyed(model, grads),
                                       jflatten(jgrads),
                                       f"{arch} grads at step {step}",
                                       hold(f"grads@{step}"))
        model, opt, loss2 = train_step(model, opt, tb, step)
        assert float(loss2) == float(loss)
        assert opt["count"] == int(jopt["count"]) == \
            steps_at.index(step) + 1
        got = _flatten({"params": model, "opt": {"m": opt["m"],
                                                 "v": opt["v"]}})
        want = jflatten({"params": jparams, "opt": {"m": jopt["m"],
                                                    "v": jopt["v"]}})
        for part in ("params", "opt/m", "opt/v"):
            report[f"{part}@{step}"] = held(
                {k: v for k, v in got.items() if k.startswith(part + "/")},
                {k: v for k, v in want.items() if k.startswith(part + "/")},
                f"{arch} {part} after step {step}", hold(f"{part}@{step}"))
    return report


def test_train_step_matches_jax(pair):
    arch, jcfg, cfg, jparams = pair
    report = step_errors(arch, jcfg, cfg, jparams)
    print(f"fp32 {arch}: {json.dumps(report)}")


def state_errors(model, opt, jparams, jopt, what):
    """Each of params, opt/m and opt/v held at REL of the JAX state's."""
    got = _flatten({"params": model, "opt": {"m": opt["m"], "v": opt["v"]}})
    want = jflatten({"params": jparams, "opt": {"m": jopt["m"],
                                                "v": jopt["v"]}})
    return {part: held(
        {k: v for k, v in got.items() if k.startswith(part + "/")},
        {k: v for k, v in want.items() if k.startswith(part + "/")},
        f"{what} {part}") for part in ("params", "opt/m", "opt/v")}


def compressed_step_errors(arch, jcfg, cfg, jparams, dtype=torch.float64,
                           step=1):
    """One step of each package's ``make_train_step`` with compression,
    from the same weights and fresh moments, at step index ``step`` (WSD
    gives lr 0 at 0): the loss and every leaf of the new state, held at
    REL."""
    jset, tset = settings(dtype=dtype, compress=True)
    model = convert.params_from_numpy(cfg, jflatten(jparams), dtype=dtype,
                                      device="cpu")
    opt = adamw_init(dict(model.named_parameters()), tset.opt)
    jopt = jadamw.adamw_init(jparams, jset.opt)
    nb = batch(cfg, seed=step)
    jparams, jopt, jloss = jax.jit(jsteps.make_train_step(jcfg, jset))(
        jparams, jopt, {k: jnp.asarray(v) for k, v in nb.items()},
        jnp.asarray(step, jnp.int32))
    model, opt, loss = steps.make_train_step(cfg, tset)(
        model, opt, {k: torch.from_numpy(v) for k, v in nb.items()}, step)
    rel = abs(float(loss) - float(jloss)) / abs(float(jloss))
    assert rel <= REL, f"{arch} loss {float(loss)} vs {float(jloss)}"
    assert opt["count"] == int(jopt["count"]) == 1
    report = {f"loss@{step}": rel}
    report.update({f"{k}@{step}": v for k, v in state_errors(
        model, opt, jparams, jopt, f"{arch} compressed step").items()})
    return report


@pytest.mark.parametrize("arch", COMPRESS_ARCHS)
def test_compressed_update_from_jax_gradients_matches_jax(arch, monkeypatch):
    """fp32: the JAX gradients of one batch, carried over, through each
    package's compression and AdamW update at step 1, held against the
    jitted JAX step.  The codes and scales of every JAX leaf (a leaf
    stacked over periods has one scale) equal the reference function's bit
    for bit."""
    jset, tset = settings(compress=True)
    jcfg, cfg = jmc.smoke(jget_config(arch)), smoke(get_config(arch))
    jparams = jlm.init_model(jcfg, jax.random.key(0))
    nb = batch(cfg, seed=1)
    jgrads = jax.grad(lambda p: jlm.forward(jcfg, p, {
        k: jnp.asarray(v) for k, v in nb.items()}, remat="none")[0])(jparams)

    @jax.jit
    def jupdate(params, opt, grads, step):
        g = jsteps._compressed_allreduce(grads, jset.compress, None)
        lr_scale = jsteps.wsd_schedule(step, warmup=jset.warmup,
                                       stable=jset.stable, decay=jset.decay)
        return jadamw.adamw_update(g, opt, params, jset.opt, lr_scale)

    jopt = jadamw.adamw_init(jparams, jset.opt)
    # The reference function as written (eager): under jax.jit XLA turns
    # the scale's division by qmax into a product by its fp32 reciprocal,
    # an ulp away in about 5% of leaves (tests/test_torch_compress.py).
    jq, js, _ = jcompress.compress_gradients(jgrads, jset.compress)
    jparams2, jopt2 = jupdate(jparams, jopt, jgrads, jnp.asarray(1))

    model = convert.params_from_numpy(cfg, jflatten(jparams), device="cpu")
    grads = dict(convert.params_from_numpy(cfg, jflatten(jgrads),
                                           device="cpu").named_parameters())
    grads = {n: g.detach() for n, g in grads.items()}
    codes = {}

    def recorded(tree, ccfg):
        q, s, pre = compress_gradients(tree, ccfg)
        codes.update({k: (q[k].numpy(), s[k].numpy()) for k in q})
        return q, s, pre

    monkeypatch.setattr(steps, "compress_gradients", recorded)
    deq = steps._compressed_allreduce(cfg, grads, tset.compress, None)
    jq, js = jflatten(jq), jflatten(js)
    assert sorted(codes) == sorted(jq)
    for k, (q, s) in codes.items():
        np.testing.assert_array_equal(q, jq[k], err_msg=k)
        assert s.tobytes() == np.asarray(js[k]).tobytes(), k
    opt = adamw_init(dict(model.named_parameters()), tset.opt)
    adamw_update(deq, opt, dict(model.named_parameters()), tset.opt,
                 wsd_schedule(1, warmup=tset.warmup, stable=tset.stable,
                              decay=tset.decay))
    report = state_errors(model, opt, jparams2, jopt2,
                          f"{arch} update from JAX gradients")
    print(f"fp32 {arch} compressed update: {json.dumps(report)}")


def widen_fp32_casts():
    """Run both packages in float64: every fp32 cast of their model and
    optimizer code (``jnp.float32``, ``.float()``, ``torch.float32``)
    becomes float64.  For a separate process only."""
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
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


def test_step0_leaves_the_parameters_and_moves_the_moments():
    """WSD gives lr 0 at step 0 (src/repro/optim/schedules.py:14-18): the
    parameters stay bit-identical while m and v take the gradient."""
    _, tset = settings()
    cfg = smoke(get_config("llama3.2-1b"))
    model = init_model(cfg, 0, device="cpu")
    before = convert.numpy_from_params(model)
    opt = adamw_init(dict(model.named_parameters()), tset.opt)
    b = {k: torch.from_numpy(v) for k, v in batch(cfg).items()}
    steps.make_train_step(cfg, tset)(model, opt, b, 0)
    after = convert.numpy_from_params(model)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
    assert all(float(m.abs().max()) > 0 for m in opt["m"].values())


def test_remat_gives_the_same_step(pair):
    """Recomputing each layer in the backward ("dots" keeps the matrix
    products, "full" nothing) changes no number of a step with lr > 0."""
    arch, jcfg, cfg, jparams = pair
    b = {k: torch.from_numpy(v) for k, v in batch(cfg, 1).items()}
    out = {}
    for remat in ("none", "dots", "full"):
        _, tset = settings(remat)
        model = convert.params_from_numpy(cfg, jflatten(jparams),
                                          device="cpu")
        opt = adamw_init(dict(model.named_parameters()), tset.opt)
        loss = steps.make_train_step(cfg, tset)(model, opt, b, 1)[2]
        out[remat] = (float(loss), _flatten(
            {"params": model, "opt": {"m": opt["m"], "v": opt["v"]}}))
    for remat in ("dots", "full"):
        assert out[remat][0] == out["none"][0]
        for k, v in out["none"][1].items():
            np.testing.assert_array_equal(out[remat][1][k], v,
                                          err_msg=f"{remat} {k}")


def test_prefill_and_decode_steps_are_the_models():
    cfg = smoke(get_config("llama3.2-1b"))
    model = init_model(cfg, 0, device="cpu")
    toks = torch.from_numpy(batch(cfg)["tokens"][:, :8]).long()
    logits, cache = steps.make_prefill_step(cfg, 16)(model, {"tokens": toks})
    want, _, _ = model.prefill({"tokens": toks}, 16)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    nxt = {"tokens": logits[:, -1:, :cfg.vocab_size].argmax(-1)}
    got, _ = steps.make_decode_step(cfg)(model, nxt, cache, 8)
    assert got.shape == (2, 1, cfg.padded_vocab)
    assert torch.isfinite(got).all()


if __name__ == "__main__":          # the float64 run, in its own process
    assert sys.argv[1] == "--float64"
    widen_fp32_casts()
    arch = sys.argv[2]
    jcfg = jmc.smoke(jget_config(arch))
    jparams = jax.tree_util.tree_map(
        lambda a: a.astype(np.float64),
        jlm.init_model(jcfg, jax.random.key(0)))
    if sys.argv[3:] == ["--compress"]:
        # One compressed step of make_train_step at index 1: the loss,
        # both moments and the moved parameters.
        report = compressed_step_errors(arch, jcfg, smoke(get_config(arch)),
                                        jparams)
    else:
        # One step with lr > 0 from fresh moments: loss, gradients, both
        # moments and the moved parameters.
        report = step_errors(arch, jcfg, smoke(get_config(arch)), jparams,
                             dtype=torch.float64, steps_at=(1,))
    print(json.dumps({"dtype": "float64", **report}))
