"""The port's mLSTM scan against the JAX package, on the CPU.

The port's plain ``ref.mlstm_ref`` against ``repro.kernels.ref.mlstm_ref``,
and ``ops.mlstm`` (which takes the plain version for CPU tensors) against the
Pallas ``mlstm_scan`` run in interpret mode, over the sweep of
tests/test_kernels.py, one full-width head (hd 384) and a state carried over
two calls, and the normalizer ``n`` that ``ops.mlstm`` returns with ``n0``.
The CUDA kernel itself is held against the plain version on the
card by tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("jax.experimental.pallas")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mlstm_scan import mlstm_scan as jmlstm_scan  # noqa: E402
from repro_torch.kernels import mlstm_scan, ops, ref  # noqa: E402

# The repo's kernel tolerances (tests/test_kernels.py:28-29); the state at
# 2e-2 as tests/test_kernels.py:182-183 holds it.
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
C_TOL = dict(rtol=2e-2, atol=2e-2)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The sweep of tests/test_kernels.py:157-162, shared with chip_smoke.py.
from chip_smoke import MLSTM_SWEEP  # noqa: E402

# The sweep's first three cases are the repo's; the cases after them take
# the widened kernels' head dims and chunks.  Of those, the CPU holds the
# plain version against the Pallas kernel at hd 8, 37, 100 and 512 and at
# chunk 256 (fp32); the card runs them all in both dtypes.
REPO_MLSTM = MLSTM_SWEEP[:3]
WIDE_MLSTM = [c for c in MLSTM_SWEEP[3:] if c[3] in (8, 37, 100, 512)
              or c[4] > 128]


def pair(x, dtype):
    """The same numbers as a jax array and a CPU torch tensor."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(
        TDT[dtype])


def inputs(B, S, H, hd, dtype, *, seed=0, c0_scale=0.0, k_scale=1.0):
    """q, k, v, i, f as (jax, torch) pairs in ``dtype``; c0 and n0 fp32."""
    rs = np.random.RandomState(seed)
    q = rs.randn(B, S, H, hd)
    k = rs.randn(B, S, H, hd) * k_scale
    v = rs.randn(B, S, H, hd)
    i = 1 / (1 + np.exp(-rs.randn(B, S, H)))
    f = 1 / (1 + np.exp(-(rs.randn(B, S, H) + 2.0)))
    c0 = rs.randn(B, H, hd, hd) * c0_scale
    pairs = [pair(t, dtype) for t in (q, k, v, i, f)]
    return pairs, pair(c0, "float32"), pair(np.zeros((B, H, hd)), "float32")


def close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# Plain version vs the JAX oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", REPO_MLSTM)
def test_mlstm_ref_matches_jax(case, dtype):
    B, S, H, hd, _ = case
    pairs, (jc0, c0), (jn0, n0) = inputs(B, S, H, hd, dtype, c0_scale=0.3)
    (jq, q), (jk, k), (jv, v), (ji, i), (jf, f) = pairs
    y, c_last, n_last = ref.mlstm_ref(q, k, v, i, f, c0, n0)
    jy, jc, jn = jref.mlstm_ref(jq, jk, jv, ji, jf, jc0, jn0)
    assert y.dtype == c_last.dtype == torch.float32
    close(y, jy, **TOL["float32"])
    close(c_last, jc, **TOL["float32"])
    close(n_last, jn, **TOL["float32"])


# ---------------------------------------------------------------------------
# ops.mlstm (CPU tensors) vs the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", REPO_MLSTM)
def test_ops_mlstm_matches_pallas(case, dtype):
    B, S, H, hd, chunk = case
    pairs, (jc0, c0), _ = inputs(B, S, H, hd, dtype)
    (jq, q), (jk, k), (jv, v), (ji, i), (jf, f) = pairs
    y, c_last = ops.mlstm(q, k, v, i, f, c0, chunk=chunk)
    jy, jc = jmlstm_scan(jq, jk, jv, ji, jf, jc0, chunk=chunk,
                         interpret=True)
    assert y.dtype == TDT[dtype] and y.shape == (B, S, H, hd)
    assert c_last.dtype == torch.float32 and c_last.shape == (B, H, hd, hd)
    close(y, jy, **TOL[dtype])
    close(c_last, jc, **C_TOL)


@pytest.mark.parametrize("case", WIDE_MLSTM)
def test_ops_mlstm_matches_pallas_at_any_head_dim(case):
    test_ops_mlstm_matches_pallas(case, "float32")


def test_ops_mlstm_full_width_head_matches_pallas():
    """One head at xlstm-125m's width: hd = 1536 / 4 = 384, with a nonzero
    incoming state and k scaled as the block scales it."""
    pairs, (jc0, c0), (jn0, n0) = inputs(1, 16, 1, 384, "float32", seed=3,
                                         c0_scale=0.05,
                                         k_scale=1 / math.sqrt(384))
    (jq, q), (jk, k), (jv, v), (ji, i), (jf, f) = pairs
    y, c_last = ops.mlstm(q, k, v, i, f, c0, chunk=8)
    jy, jc = jmlstm_scan(jq, jk, jv, ji, jf, jc0, chunk=8, interpret=True)
    close(y, jy, **TOL["float32"])
    close(c_last, jc, **TOL["float32"])
    jy, jc, _ = jref.mlstm_ref(jq, jk, jv, ji, jf, jc0, jn0)
    close(y, jy, **TOL["float32"])
    close(c_last, jc, **TOL["float32"])


@pytest.mark.parametrize("in_place", [False, True], ids=["fresh", "in_place"])
def test_state_carries_across_two_calls(in_place):
    """Two calls, the second starting from the first's state, equal one call
    over the whole sequence (and the JAX kernel's).  ``out=c0`` updates the
    state in place, as the model's decode step does."""
    B, S, H, hd, chunk = 2, 40, 2, 32, 16
    pairs, (jc0, c0), _ = inputs(B, S, H, hd, "float32", seed=5,
                                 c0_scale=0.2)
    (jq, q), (jk, k), (jv, v), (ji, i), (jf, f) = pairs
    cut = 23
    state = c0.clone()
    y1, c1 = ops.mlstm(q[:, :cut], k[:, :cut], v[:, :cut], i[:, :cut],
                       f[:, :cut], state, chunk=chunk,
                       out=state if in_place else None)
    y2, c2 = ops.mlstm(q[:, cut:], k[:, cut:], v[:, cut:], i[:, cut:],
                       f[:, cut:], c1, chunk=chunk,
                       out=c1 if in_place else None)
    if in_place:
        assert c1 is state and c2 is state
    y, c_last = ops.mlstm(q, k, v, i, f, c0, chunk=chunk)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(c2, c_last, rtol=1e-5, atol=1e-5)
    jy, jc = jmlstm_scan(jq, jk, jv, ji, jf, jc0, chunk=chunk,
                         interpret=True)
    close(torch.cat([y1, y2], dim=1), jy, **TOL["float32"])
    close(c2, jc, **TOL["float32"])


# ---------------------------------------------------------------------------
# The normalizer: ops.mlstm(..., n0=...) against the JAX oracle's n
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", REPO_MLSTM)
def test_ops_mlstm_normalizer_matches_jax(case, dtype):
    """With ``n0``, ``ops.mlstm`` also returns n_last (C's update with
    v = 1), as ``repro.kernels.ref.mlstm_ref`` carries it; y and C are
    those of the call without ``n0``."""
    B, S, H, hd, chunk = case
    pairs, (jc0, c0), _ = inputs(B, S, H, hd, dtype, c0_scale=0.3)
    n0_np = np.random.RandomState(9).randn(B, H, hd) * 0.3
    jn0, n0 = pair(n0_np, "float32")
    (jq, q), (jk, k), (jv, v), (ji, i), (jf, f) = pairs
    y, c_last, n_last = ops.mlstm(q, k, v, i, f, c0, n0=n0, chunk=chunk)
    _, _, jn = jref.mlstm_ref(jq, jk, jv, ji, jf, jc0, jn0)
    assert n_last.dtype == torch.float32 and n_last.shape == (B, H, hd)
    close(n_last, jn, **TOL["float32"])
    y2, c2 = ops.mlstm(q, k, v, i, f, c0, chunk=chunk)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(c_last, c2, rtol=0, atol=0)


def test_ops_mlstm_updates_the_normalizer_in_place():
    """``n_out=n0`` (and ``out=c0``) write the states into the inputs, as
    the model's decode step does, over two calls that carry them."""
    B, S, H, hd, chunk = 2, 40, 2, 32, 16
    pairs, (jc0, c0), _ = inputs(B, S, H, hd, "float32", seed=7,
                                 c0_scale=0.2)
    jn0, n0 = pair(np.random.RandomState(8).randn(B, H, hd) * 0.2,
                   "float32")
    (jq, q), (jk, k), (jv, v), (ji, i), (jf, f) = pairs
    c_state, n_state = c0.clone(), n0.clone()
    for sl in (slice(0, 23), slice(23, S)):
        _, c_ret, n_ret = ops.mlstm(q[:, sl], k[:, sl], v[:, sl], i[:, sl],
                                    f[:, sl], c_state, n0=n_state,
                                    chunk=chunk, out=c_state, n_out=n_state)
        assert c_ret is c_state and n_ret is n_state
    _, jc, jn = jref.mlstm_ref(jq, jk, jv, ji, jf, jc0, jn0)
    close(c_state, jc, **TOL["float32"])
    close(n_state, jn, **TOL["float32"])


def test_ops_mlstm_without_n0_returns_two_values():
    pairs, (_, c0), (_, n0) = inputs(1, 8, 1, 16, "float32")
    ts = [t for _, t in pairs]
    assert len(ops.mlstm(*ts, c0, chunk=4)) == 2
    assert len(ops.mlstm(*ts, c0, n0=n0, chunk=4)) == 3
    with pytest.raises(ValueError, match="n_out needs n0"):
        ops.mlstm(*ts, c0, chunk=4, n_out=n0)


def test_launch_counters_stay_zero_on_cpu():
    ops.reset_launch_counts()
    pairs, (_, c0), _ = inputs(1, 8, 1, 16, "float32")
    ops.mlstm(*(t for _, t in pairs), c0, chunk=4)
    assert ops.launch_counts() == {"flash_attention": 0, "flash_decode": 0,
                                   "mlstm_scan": 0, "mamba_scan": 0}


def test_kernel_wrapper_refuses_cpu_tensors():
    pairs, (_, c0), (_, n0) = inputs(1, 8, 1, 16, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        mlstm_scan.mlstm_scan(*(t for _, t in pairs), c0)
    with pytest.raises(ValueError, match="CUDA"):
        mlstm_scan.mlstm_scan(*(t for _, t in pairs), c0, n0=n0)
