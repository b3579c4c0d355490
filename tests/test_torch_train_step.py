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
"""
import dataclasses
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
from repro_torch import convert  # noqa: E402
from repro_torch.ckpt.shards import _flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import init_model, smoke  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

REL = 2e-5
ARCHS = ["llama3.2-1b", "xlstm-125m", "jamba-v0.1-52b"]
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
    toks = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[1, :3] = -1                                  # masked labels
    return {"tokens": toks, "labels": labels}


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


def settings(remat="none", dtype=torch.float32):
    """The trainer's settings in both packages, moments in ``dtype``."""
    jdtype = np.float64 if dtype == torch.float64 else np.float32
    jset = jsteps.TrainSettings(remat="none", opt=jadamw.AdamWConfig(
        lr=LR, weight_decay=WD, state_dtype=jdtype), warmup=WARMUP,
        stable=10**6, decay=1)
    tset = steps.TrainSettings(remat=remat, opt=AdamWConfig(
        lr=LR, weight_decay=WD, state_dtype=dtype), warmup=WARMUP,
        stable=10**6, decay=1)
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
    from repro_torch.optim import adamw, schedules
    for mod in (blocks, layers, moe, ref, adamw, schedules):
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


def test_compression_is_refused():
    cfg = smoke(get_config("llama3.2-1b"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        steps.make_train_step(cfg, dataclasses.replace(
            steps.TrainSettings(), compress=object()))


if __name__ == "__main__":          # the float64 run, in its own process
    assert sys.argv[1] == "--float64"
    widen_fp32_casts()
    arch = sys.argv[2]
    jcfg = jmc.smoke(jget_config(arch))
    jparams = jax.tree_util.tree_map(
        lambda a: a.astype(np.float64),
        jlm.init_model(jcfg, jax.random.key(0)))
    # One step with lr > 0 from fresh moments: loss, gradients, both
    # moments and the moved parameters.
    report = step_errors(arch, jcfg, smoke(get_config(arch)), jparams,
                         dtype=torch.float64, steps_at=(1,))
    print(json.dumps({"dtype": "float64", **report}))
