"""Layers of the PyTorch port against ``repro.models.layers`` (fp32, CPU)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def pair(seed, shape, scale=1.0):
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def test_rms_norm():
    jx, x = pair(0, (2, 5, 64))
    jw, w = pair(1, (64,), 0.1)
    close(tl.rms_norm(x, w, 1e-6), jl.rms_norm(jx, jw, 1e-6))


def test_rms_norm_bf16_keeps_dtype():
    jx, x = pair(0, (2, 5, 64))
    jw, w = pair(1, (64,), 0.1)
    got = tl.rms_norm(x.bfloat16(), w, 1e-6)
    want = jl.rms_norm(jx.astype(jnp.bfloat16), jw, 1e-6)
    assert got.dtype == torch.bfloat16
    close(got.float(), want.astype(jnp.float32), rtol=1e-2, atol=1e-2)


def test_softcap():
    jx, x = pair(2, (3, 7), 40.0)
    close(tl.softcap(x, 30.0), jl.softcap(jx, 30.0))
    close(tl.softcap(x, 0.0), jl.softcap(jx, 0.0))


def test_rope_freqs_are_identical():
    np.testing.assert_array_equal(tl.rope_freqs(64, 500_000.0),
                                  jl.rope_freqs(64, 500_000.0))


@pytest.mark.parametrize("offset", [0, 37])
def test_apply_rope(offset):
    jx, x = pair(3, (2, 9, 4, 16))
    jpos = jl.text_positions(2, 9, offset)
    pos = tl.text_positions(2, 9, offset)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    close(tl.apply_rope(x, pos, 500_000.0), jl.apply_rope(jx, jpos, 500_000.0))


def test_dense_and_swiglu():
    jx, x = pair(4, (2, 5, 64))
    jg, g = pair(5, (64, 128), 0.125)
    ju, u = pair(6, (64, 128), 0.125)
    jd, d = pair(7, (128, 64), 0.09)
    close(tl.dense(x, g), jl.dense(jx, jg))
    close(tl.swiglu(x, g, u, d), jl.swiglu(jx, jg, ju, jd))


ATTN_CASES = [
    # (S, T, Nq, Nkv, causal, window, cap, q_offset, kv_len)
    (12, 12, 4, 2, True, 0, 0.0, 0, None),      # prefill, GQA
    (12, 12, 4, 4, True, 5, 20.0, 0, None),     # window + softcap
    (1, 24, 4, 2, False, 0, 0.0, 13, 14),       # decode against a cache
    (3, 24, 4, 1, False, 0, 0.0, 13, 16),       # multi-token decode
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention(case):
    S, T, Nq, Nkv, causal, window, cap, q_offset, kv_len = case
    jq, q = pair(8, (2, S, Nq, 16))
    jk, k = pair(9, (2, T, Nkv, 16))
    jv, v = pair(10, (2, T, Nkv, 16))
    got = tl.attention(q, k, v, causal=causal, window=window, cap=cap,
                       q_offset=q_offset, kv_len=kv_len)
    want = jl.attention(jq, jk, jv, causal=causal, window=window, cap=cap,
                        q_offset=q_offset, kv_len=kv_len)
    close(got, want)


def test_init_tensor_distributions():
    gen = torch.Generator().manual_seed(0)
    w = tl.init_tensor(tl.PSpec((256, 512), (None, None)), gen, dtype=torch.float32,
                       device="cpu")
    assert abs(float(w.std()) - 1 / 16) < 2e-3
    e = tl.init_tensor(tl.PSpec((512, 64), (None, None), scale=0.02), gen,
                       dtype=torch.float32, device="cpu")
    assert abs(float(e.std()) - 0.02) < 1e-3
    z = tl.init_tensor(tl.PSpec((8,), (None,), init="zeros"), gen,
                       dtype=torch.bfloat16, device="cpu")
    assert z.dtype == torch.bfloat16 and not z.any()
