"""Attention kernels of the PyTorch port against the JAX package.

On the CPU: the port's plain ``attention_ref`` against
``repro.kernels.ref.attention_ref`` over the sweeps of tests/test_kernels.py,
and the port's ``ops`` entry points (which take the plain version for CPU
tensors) against the Pallas kernels run in interpret mode.  The CUDA kernels
themselves are held against the plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("jax.experimental.pallas")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import flash_decode as jflash_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash_attention  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# The repo's kernel tolerances (tests/test_kernels.py:28-29).
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The sweeps of tests/test_kernels.py:35-44 and :76-86, shared with the
# on-card checks of chip_smoke.py.
from chip_smoke import ATTN_SWEEP, DECODE_SWEEP  # noqa: E402

# The sweeps' first cases (the repo's and the served models' head dims);
# the cases after them take the head dims and groups of the widened
# kernels.  Of those, the CPU holds the plain version against the Pallas
# kernels at the ones below (hd 1, 96, 100, 320 and 512; hd 37, hd 512 at g
# 8, and g 24 and 71 past the old g·hd of 2,048); the card runs them all.
REPO_ATTN, REPO_DECODE = ATTN_SWEEP[:16], DECODE_SWEEP[:14]
WIDE_ATTN = [c for c in ATTN_SWEEP[16:] if c[5] in (1, 96, 100, 320, 512)]
WIDE_DECODE = [c for c in DECODE_SWEEP[14:]
               if (c[4], c[1] // c[2]) in {(37, 2), (512, 8), (128, 24),
                                           (64, 71)}]


def pair(seed, shape, dtype):
    """The same numbers as a jax array and a CPU torch tensor."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return (jnp.asarray(x).astype(JDT[dtype]),
            torch.from_numpy(x).to(TDT[dtype]))


def close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def attn_inputs(case, dtype):
    B, Hq, Hkv, Sq, Skv, hd = case[:6]
    return (pair(1, (B, Hq, Sq, hd), dtype), pair(2, (B, Hkv, Skv, hd), dtype),
            pair(3, (B, Hkv, Skv, hd), dtype))


def decode_inputs(case, dtype):
    B, Hq, Hkv, T, hd = case[:5]
    return (pair(7, (B, Hq, 1, hd), dtype), pair(8, (B, Hkv, T, hd), dtype),
            pair(9, (B, Hkv, T, hd), dtype))


# ---------------------------------------------------------------------------
# Plain version vs the JAX oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", REPO_ATTN)
def test_attention_ref_matches_jax(case, dtype):
    causal, window, cap = case[6:]
    (jq, q), (jk, k), (jv, v) = attn_inputs(case, dtype)
    got = ref.attention_ref(q, k, v, causal=causal, window=window,
                            softcap=cap)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window,
                              softcap=cap)
    assert got.dtype == TDT[dtype]
    close(got, want, **TOL[dtype])


def test_attention_ref_q_offset_matches_jax():
    jq, q = pair(4, (1, 2, 16, 32), "float32")
    jk, k = pair(5, (1, 2, 64, 32), "float32")
    jv, v = pair(6, (1, 2, 64, 32), "float32")
    got = ref.attention_ref(q, k, v, causal=True, q_offset=48)
    want = jref.attention_ref(jq, jk, jv, causal=True, q_offset=48)
    close(got, want, **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", REPO_DECODE)
def test_decode_ref_matches_jax(case, dtype):
    kv_len, cap = case[5:]
    (jq, q), (jk, k), (jv, v) = decode_inputs(case, dtype)
    got = ref.attention_ref(q, k, v, causal=False, softcap=cap,
                            kv_len=kv_len)
    want = jref.attention_ref(jq, jk, jv, causal=False, softcap=cap,
                              kv_len=kv_len)
    close(got, want, **TOL[dtype])


# ---------------------------------------------------------------------------
# ops entry points (CPU tensors) vs the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [ATTN_SWEEP[1], ATTN_SWEEP[3],
                                  ATTN_SWEEP[6]] + WIDE_ATTN)
def test_ops_flash_attention_matches_pallas(case):
    causal, window, cap = case[6:]
    (jq, q), (jk, k), (jv, v) = attn_inputs(case, "float32")
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap)
    want = jflash_attention(jq, jk, jv, causal=causal, window=window,
                            softcap=cap, block_q=32, block_kv=32,
                            interpret=True)
    close(got, want, **TOL["float32"])


@pytest.mark.parametrize("case", [DECODE_SWEEP[1], DECODE_SWEEP[2],
                                  DECODE_SWEEP[5]] + WIDE_DECODE)
def test_ops_flash_decode_matches_pallas(case):
    kv_len, cap = case[5:]
    (jq, q), (jk, k), (jv, v) = decode_inputs(case, "float32")
    got = ops.flash_decode(q, k, v, kv_len, softcap=cap)
    want = jflash_decode(jq, jk, jv, jnp.int32(kv_len), softcap=cap,
                         block_kv=64, interpret=True)
    close(got, want, **TOL["float32"])


def test_ops_attention_routes_decode_and_prefill_layouts():
    """``ops.attention`` takes the model's (B,S,N,hd) layout: a causal call
    equals flash_attention on the transposes, a one-token call with kv_len
    equals flash_decode."""
    (_, q), (_, k), (_, v) = attn_inputs(ATTN_SWEEP[1], "float32")
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # (B,S,N,hd)
    got = ops.attention(q, k, v, causal=True)
    want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got = ops.attention(q[:, 5:6], k, v, causal=False, q_offset=5, kv_len=6)
    want = ref.attention_ref(q[:, 5:6].transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=False,
                             kv_len=6).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_launch_counters_stay_zero_on_cpu():
    ops.reset_launch_counts()
    (_, q), (_, k), (_, v) = attn_inputs(ATTN_SWEEP[0], "float32")
    ops.flash_attention(q, k, v)
    ops.flash_decode(q[:, :, :1], k, v, 10)
    assert ops.launch_counts() == {"flash_attention": 0, "flash_decode": 0,
                                   "mlstm_scan": 0, "mamba_scan": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_attention
    (_, q), (_, k), (_, v) = attn_inputs(ATTN_SWEEP[0], "float32")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q[:, :, :1], k, v, 10)
