"""The port's selective scan (Mamba) against the JAX package, on the CPU.

The port's plain ``ref.mamba_scan_ref`` against
``repro.kernels.ref.mamba_scan_ref``, and ``ops.selective_scan`` (which takes
the plain version for CPU tensors) against the Pallas ``mamba_scan`` run in
interpret mode, over the sweep of tests/test_kernels.py, one slice at
Jamba's state size and a state carried over two calls; then the model's
plain chunked scan ``blocks._ssm_scan`` against the JAX package's.  The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("jax.experimental.pallas")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan as jmamba_scan  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro_torch.kernels import mamba_scan, ops, ref  # noqa: E402
from repro_torch.models import blocks  # noqa: E402

# The repo's kernel tolerances (tests/test_kernels.py:28-29); the state at
# 5e-3 as tests/test_kernels.py:130-131 holds it.
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
H_TOL = dict(rtol=5e-3, atol=5e-3)
CARRY_TOL = dict(rtol=1e-4, atol=1e-4)       # tests/test_kernels.py:147-150
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The sweep of tests/test_kernels.py:107-112, shared with chip_smoke.py.
from chip_smoke import MAMBA_SWEEP  # noqa: E402

# The sweep's first three cases are the repo's; the cases after them take
# the widened kernel's state sizes and channel counts.  Of those, the CPU
# holds the plain version against the Pallas kernel at N 1, 12 and 256 and
# at di 37 (fp32); the card runs them all in both dtypes.
REPO_MAMBA = MAMBA_SWEEP[:3]
WIDE_MAMBA = [c for c in MAMBA_SWEEP[3:] if c[3] in (1, 12, 256)
              or c[2] == 37]


def pair(x, dtype):
    """The same numbers as a jax array and a CPU torch tensor."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(
        TDT[dtype])


def inputs(B, S, di, N, dtype, *, seed=0, h0_scale=0.0):
    """u, dt, b, c as (jax, torch) pairs in ``dtype``; a and h0 fp32.  As
    in tests/test_kernels.py: dt = softplus(normal), a = -exp(0.5 normal)."""
    rs = np.random.RandomState(seed)
    u = rs.randn(B, S, di)
    dt = np.log1p(np.exp(rs.randn(B, S, di)))
    a = -np.exp(rs.randn(di, N) * 0.5)
    b = rs.randn(B, S, N)
    c = rs.randn(B, S, N)
    h0 = rs.randn(B, di, N) * h0_scale
    return ([pair(t, dtype) for t in (u, dt)], pair(a, "float32"),
            [pair(t, dtype) for t in (b, c)], pair(h0, "float32"))


def close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# Plain version vs the JAX oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", REPO_MAMBA)
def test_mamba_scan_ref_matches_jax(case, dtype):
    B, S, di, N, _ = case
    ((ju, u), (jdt, dt)), (ja, a), ((jb, b), (jc, c)), (jh0, h0) = inputs(
        B, S, di, N, dtype, h0_scale=0.3)
    y, h = ref.mamba_scan_ref(u, dt, a, b, c, h0)
    jy, jh = jref.mamba_scan_ref(ju, jdt, ja, jb, jc, jh0)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, di) and h.shape == (B, di, N)
    close(y, jy, **TOL[dtype])
    close(h, jh, **H_TOL)


# ---------------------------------------------------------------------------
# ops.selective_scan (CPU tensors) vs the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", REPO_MAMBA)
def test_ops_selective_scan_matches_pallas(case, dtype):
    B, S, di, N, chunk = case
    ((ju, u), (jdt, dt)), (ja, a), ((jb, b), (jc, c)), (jh0, h0) = inputs(
        B, S, di, N, dtype, seed=1)
    y, h = ops.selective_scan(u, dt, a, b, c, h0)
    jy, jh = jmamba_scan(ju, jdt, ja, jb, jc, jh0, chunk=chunk, di_block=di,
                         interpret=True)
    assert y.dtype == TDT[dtype] and y.shape == (B, S, di)
    assert h.dtype == torch.float32 and h.shape == (B, di, N)
    close(y, jy, **TOL[dtype])
    close(h, jh, **H_TOL)


@pytest.mark.parametrize("case", WIDE_MAMBA)
def test_ops_selective_scan_matches_pallas_at_any_state_size(case):
    test_ops_selective_scan_matches_pallas(case, "float32")


def test_ops_selective_scan_jamba_width_slice():
    """A slice at Jamba's state size N = 16: (1, 64, 256, 16), 256 channels
    of its di = 8192, from a nonzero state, against the Pallas kernel and
    the JAX oracle."""
    ((ju, u), (jdt, dt)), (ja, a), ((jb, b), (jc, c)), (jh0, h0) = inputs(
        1, 64, 256, 16, "float32", seed=2, h0_scale=0.5)
    y, h = ops.selective_scan(u, dt, a, b, c, h0)
    jy, jh = jmamba_scan(ju, jdt, ja, jb, jc, jh0, interpret=True)
    close(y, jy, **TOL["float32"])
    close(h, jh, **TOL["float32"])
    jy, jh = jref.mamba_scan_ref(ju, jdt, ja, jb, jc, jh0)
    close(y, jy, **TOL["float32"])
    close(h, jh, **TOL["float32"])


@pytest.mark.parametrize("in_place", [False, True], ids=["fresh", "in_place"])
def test_state_carries_across_two_calls(in_place):
    """Two calls, the second starting from the first's state, equal one call
    over the whole sequence (and the JAX kernel's).  ``out=h0`` updates the
    state in place, as the model's decode step does."""
    B, S, di, N = 1, 48, 32, 8
    ((ju, u), (jdt, dt)), (ja, a), ((jb, b), (jc, c)), (jh0, h0) = inputs(
        B, S, di, N, "float32", seed=3)
    cut = 24
    state = h0.clone()
    y1, h1 = ops.selective_scan(u[:, :cut], dt[:, :cut], a, b[:, :cut],
                                c[:, :cut], state,
                                out=state if in_place else None)
    y2, h2 = ops.selective_scan(u[:, cut:], dt[:, cut:], a, b[:, cut:],
                                c[:, cut:], h1, out=h1 if in_place else None)
    if in_place:
        assert h1 is state and h2 is state
    y, h = ops.selective_scan(u, dt, a, b, c, h0)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, **CARRY_TOL)
    torch.testing.assert_close(h2, h, **CARRY_TOL)
    jy, jh = jmamba_scan(ju, jdt, ja, jb, jc, jh0, chunk=16, di_block=di,
                         interpret=True)
    close(torch.cat([y1, y2], dim=1), jy, **CARRY_TOL)
    close(h2, jh, **CARRY_TOL)


# ---------------------------------------------------------------------------
# The model's plain chunked scan vs the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 64, 100], ids=["S1", "S64", "S100"])
def test_ssm_scan_matches_jax(S):
    """``blocks._ssm_scan`` (doubling scan in 64-row chunks, ragged tail
    padded with dt = 0) against ``repro.models.blocks._ssm_scan``
    (``jax.lax.associative_scan``) and the sequential oracle: the two
    trees round sums in another order, hence 1e-5."""
    B, di, N = 2, 48, 8
    ((ju, u), (jdt, dt)), (ja, a), ((jb, b), (jc, c)), (jh0, h0) = inputs(
        B, S, di, N, "float32", seed=4, h0_scale=0.3)
    y, h = blocks._ssm_scan(u, dt, a, b, c, h0)
    jy, jh = jblocks._ssm_scan(ju, jdt, ja, jb, jc, jh0)
    assert y.shape == (B, S, di) and h.shape == (B, di, N)
    close(y, jy, rtol=1e-5, atol=1e-5)
    close(h, jh, rtol=1e-5, atol=1e-5)
    ys, hs = ref.mamba_scan_ref(u, dt, a, b, c, h0)
    torch.testing.assert_close(y, ys, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, hs, rtol=1e-5, atol=1e-5)


def test_launch_counters_stay_zero_on_cpu():
    ops.reset_launch_counts()
    ((_, u), (_, dt)), (_, a), ((_, b), (_, c)), (_, h0) = inputs(
        1, 8, 16, 4, "float32")
    ops.selective_scan(u, dt, a, b, c, h0)
    assert ops.launch_counts() == {"flash_attention": 0, "flash_decode": 0,
                                   "mlstm_scan": 0, "mamba_scan": 0}


def test_kernel_wrapper_refuses_cpu_tensors():
    ((_, u), (_, dt)), (_, a), ((_, b), (_, c)), (_, h0) = inputs(
        1, 8, 16, 4, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan.mamba_scan(u, dt, a, b, c, h0)
