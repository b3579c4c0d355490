"""The port's AdamW and LR schedules against the JAX package's, on the CPU.

Random trees (numpy, from a seed) of fp32 leaves go through
``repro.optim.adamw_update`` and ``repro_torch.optim.adamw_update`` for
three steps, with fp32 and bf16 moments and with global-norm clipping
active and inactive; the parameters and both moments are held within 2e-5
of each leaf's largest value in fp32, and bf16 moments to the rounding of
one bf16 ulp.  The schedules are held at step 0, inside the warm-up, at
its end, and deep in the decay.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, cosine_schedule, global_norm,
                               wsd_schedule)

REL = 2e-5
SHAPES = {"embed": (64, 16), "ln": (16,), "w": (16, 48), "b": (3, 16, 8)}


def tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def close(got, want, rel=REL):
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = got[k].detach().float().numpy()
        err = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
        assert err <= rel, f"{k}: {err:g} > {rel}"


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("clipping", [True, False], ids=["clip", "noclip"])
def test_adamw_matches_jax(state, clipping):
    # Gradients of norm ~60 against grad_clip 1 (clipped), or of norm ~0.6
    # against grad_clip 10 (not clipped).
    grad_clip = 1.0 if clipping else 10.0
    jcfg = jadamw.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=grad_clip,
                              state_dtype=getattr(jnp, state))
    tcfg = AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=grad_clip,
                       state_dtype=getattr(torch, state))
    jp = {k: jnp.asarray(v) for k, v in tree(0).items()}
    tp = {k: torch.tensor(v) for k, v in tree(0).items()}
    js, ts = jadamw.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for step in range(3):
        g = tree(10 + step, scale=1.0 if clipping else 0.01)
        gnorm = float(jadamw.global_norm(g))
        assert (gnorm > grad_clip) == clipping
        assert float(global_norm({k: torch.tensor(v) for k, v in g.items()})
                     ) == pytest.approx(gnorm, rel=1e-6)
        lr_scale = 0.5 + 0.25 * step
        jp, js = jadamw.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                     js, jp, jcfg, jnp.float32(lr_scale))
        tp, ts = adamw_update({k: torch.tensor(v) for k, v in g.items()},
                              ts, tp, tcfg, torch.tensor(lr_scale))
        assert ts["count"] == int(js["count"]) == step + 1
        close(tp, jp)
        for part in ("m", "v"):
            assert ts[part]["w"].dtype == getattr(torch, state)
            if state == "float32":
                close(ts[part], js[part])
            else:       # bf16 moments: within one bf16 rounding (2^-8)
                close(ts[part], js[part], rel=2 ** -8)


def test_weight_decay_reaches_every_leaf():
    """Decay applies to norms too (src/repro/optim/adamw.py:59): with zero
    gradients every leaf shrinks by lr * weight_decay * p."""
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5)
    p = {k: torch.tensor(v) for k, v in tree(1).items()}
    before = {k: v.clone() for k, v in p.items()}
    st = adamw_init(p, cfg)
    adamw_update({k: torch.zeros_like(v) for k, v in p.items()}, st, p, cfg)
    for k in p:
        torch.testing.assert_close(p[k], before[k] * (1 - 0.1 * 0.5))


@pytest.mark.parametrize("step", [0, 1, 49, 100, 150, 10_400, 10_900, 20_000])
def test_wsd_matches_jax(step):
    kw = dict(warmup=100, stable=10_000, decay=1_000)
    got = float(wsd_schedule(step, **kw))
    want = float(jsched.wsd_schedule(step, **kw))
    assert got == pytest.approx(want, rel=1e-6, abs=0)
    if step == 0:
        assert got == 0.0


@pytest.mark.parametrize("step", [0, 5, 20, 21, 60, 99, 100, 500])
def test_cosine_matches_jax(step):
    kw = dict(warmup=20, total=100)
    got = float(cosine_schedule(step, **kw))
    want = float(jsched.cosine_schedule(step, **kw))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
