"""The port's single-shard MoE against the JAX package, on the CPU.

On the jamba smoke config (8 experts, top-2, d_model 64, expert d_ff 64):
routing, the capacity buffers (drops included), the combine and the whole
``moe_apply`` at capacity factors 1.25 and 8.0 in fp32 and bf16, and the
shared-expert branch on a smoke config built here with one shared expert.
The JAX weights are carried over as numpy arrays.  Tolerances: fp32 1e-5
(sums over d_model in another order); bf16 3e-2, the repo's kernel
tolerance, since both sides round the products to bf16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe, smoke  # noqa: E402

ARCH = "jamba-v0.1-52b"
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def configs(**changes):
    jcfg = dataclasses.replace(jmc.smoke(jget_config(ARCH)), **changes)
    cfg = dataclasses.replace(smoke(get_config(ARCH)), **changes)
    return jcfg, cfg


def weights(jcfg, dtype="float32", seed=0):
    """The JAX init of ``moe_specs`` as (jax tree, dict of torch tensors)."""
    jp = jlayers.init_params(jmoe.moe_specs(jcfg), jax.random.key(seed),
                             JDT[dtype])
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(TDT[dtype])
          for k, v in jp.items()}
    return jp, tp


def tokens(shape, dtype="float32", seed=1, shift=0.0):
    x = (np.random.RandomState(seed).randn(*shape) + shift).astype(np.float32)
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(
        TDT[dtype])


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def skewed_router(jp, tp):
    """The router with a bias column: expert 0's logit gains the sum of a
    token's features, so tokens with a positive mean all pick it and the
    capacity buffers drop assignments."""
    r = np.asarray(jp["router"], np.float32).copy()
    r[:, 0] += 1.0
    return jnp.asarray(r), torch.from_numpy(r)


def test_specs_match_jax():
    jcfg, cfg = configs(n_shared_experts=1)
    jspecs, specs = jmoe.moe_specs(jcfg), moe.moe_specs(cfg)
    assert sorted(specs) == sorted(jspecs)
    for k, s in specs.items():
        assert s.shape == jspecs[k].shape and s.init == jspecs[k].init
        assert s.stddev() == pytest.approx(jspecs[k].stddev())


@pytest.mark.parametrize("skew", [False, True], ids=["random", "skewed"])
def test_route_matches_jax(skew):
    jcfg, cfg = configs()
    jp, tp = weights(jcfg)
    jx, x = tokens((16, cfg.d_model), shift=1.0 if skew else 0.0)
    jr, r = skewed_router(jp, tp) if skew else (jp["router"], tp["router"])
    jg, jids, jaux = jmoe._route(jcfg, jr, jx)
    g, ids, aux = moe._route(cfg, r, x)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert g.dtype == aux.dtype == torch.float32
    close(g, jg, **TOL["float32"])
    close(aux, jaux, **TOL["float32"])


@pytest.mark.parametrize("factor", [1.25, 8.0])
def test_fill_capacity_buffers_matches_jax(factor):
    """The same slots, kept flags and buffers as JAX, from the same ids;
    with the skewed router at factor 1.25 most assignments are dropped."""
    jcfg, cfg = configs(capacity_factor=factor)
    jp, tp = weights(jcfg)
    jx, x = tokens((16, cfg.d_model), shift=1.0)
    jr, _ = skewed_router(jp, tp)
    jg, jids, _ = jmoe._route(jcfg, jr, jx)
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = max(k, int(factor * 16 * k / e))
    jbuf, jslot, jkeep = jmoe._fill_capacity_buffers(jx, jg, jids, e, cap)
    ids = torch.tensor(np.asarray(jids)).long()
    g = torch.tensor(np.asarray(jg))
    buf, slot, keep = moe._fill_capacity_buffers(x, g, ids, e, cap)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert buf.shape == (e, cap, cfg.d_model)
    if factor == 1.25:
        assert cap == 5 and int((~keep).sum()) > 0
        assert (slot[~keep] == e * cap).all()
    else:
        assert bool(keep.all())


def test_combine_matches_jax():
    jcfg, cfg = configs()
    jp, tp = weights(jcfg)
    jx, x = tokens((16, cfg.d_model), shift=1.0)
    jr, _ = skewed_router(jp, tp)
    jg, jids, _ = jmoe._route(jcfg, jr, jx)
    e, k, cap = cfg.n_experts, cfg.experts_per_token, 5
    _, jslot, jkeep = jmoe._fill_capacity_buffers(jx, jg, jids, e, cap)
    rs = np.random.RandomState(2).randn(e, cap, cfg.d_model)
    jout = jmoe._combine(jnp.asarray(rs, jnp.float32), jslot, jkeep, jg, 16,
                         k)
    out = moe._combine(torch.from_numpy(rs.astype(np.float32)),
                       torch.tensor(np.asarray(jslot)).long(),
                       torch.tensor(np.asarray(jkeep)),
                       torch.tensor(np.asarray(jg)), 16, k)
    assert out.dtype == torch.float32 and out.shape == (16, cfg.d_model)
    close(out, jout, **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [1.25, 8.0])
def test_moe_apply_matches_jax(factor, dtype):
    jcfg, cfg = configs(capacity_factor=factor)
    jp, tp = weights(jcfg, dtype)
    jx, x = tokens((2, 8, cfg.d_model), dtype)
    jout, jaux = jmoe.moe_apply(jcfg, jp, jx)
    out, aux = moe.moe_apply(cfg, tp, x)
    assert out.dtype == TDT[dtype] and out.shape == x.shape
    assert aux.dtype == torch.float32
    close(out, jout, **TOL[dtype])
    close(aux, jaux, **TOL[dtype])


def test_moe_apply_drops_as_jax_at_decode_capacity():
    """Four one-token rows, as one decode step of the served batch: the
    capacity is max(k, int(1.25 * 4 * 2 / E)) = k = 2, and an expert
    picked by three rows drops one, as in JAX."""
    jcfg, cfg = configs()
    jp, tp = weights(jcfg)
    jx, x = tokens((4, 1, cfg.d_model), shift=1.0)
    jr, r = skewed_router(jp, tp)
    jp = dict(jp, router=jr)
    tp = dict(tp, router=r)
    _, ids, _ = moe._route(cfg, r, x.reshape(4, -1))
    assert int((ids == 0).sum()) > 2          # expert 0 over capacity
    jout, _ = jmoe.moe_apply(jcfg, jp, jx)
    out, _ = moe.moe_apply(cfg, tp, x)
    close(out, jout, **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_expert_branch_matches_jax(dtype):
    jcfg, cfg = configs(n_shared_experts=1)
    jp, tp = weights(jcfg, dtype, seed=3)
    assert {"ws_gate", "ws_up", "ws_down"} <= set(tp)
    jx, x = tokens((2, 6, cfg.d_model), dtype, seed=4)
    jout, jaux = jmoe.moe_apply(jcfg, jp, jx)
    out, aux = moe.moe_apply(cfg, tp, x)
    close(out, jout, **TOL[dtype])
    close(aux, jaux, **TOL[dtype])
