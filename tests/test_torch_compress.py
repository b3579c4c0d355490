"""The port's int8 gradient compression against the JAX package's, on the CPU.

The same seeded numpy leaves go through ``repro.optim.compress_gradients``
and ``repro_torch.optim.compress_gradients``.  The leaves include exact
``.5`` ties of ``g / scale`` (a scale that is a power of two), an all-zero
leaf (the 1e-12 floor of the scale), a leaf at 1e-3 scale and a bf16 leaf.
The int8 codes and fp32 scales must equal the reference function's bit for
bit, with and without an error-feedback buffer; the dequantized values and
the residuals are held at the repo's fp32 tolerance, 2e-5
(tests/test_kernels.py:28).

Under ``jax.jit`` (as the JAX train step runs it) XLA rewrites the scale's
division by the constant qmax into a product by its fp32 reciprocal, which
lands an ulp away from the true quotient for about one max in twenty (and
CUDA does the same with a Python-number divisor).  The port divides, as
the function is written, on every device; against the jitted function its
scales are held within one ulp (and its codes equal on these leaves).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch import optim  # noqa: E402

TOL = 2e-5


def leaves(seed=0):
    """{name: fp32 numpy leaf}; the "bf16" leaf is cast to bf16."""
    rng = np.random.RandomState(seed)
    ties = (np.arange(-127, 127) + 0.5).astype(np.float32) * 0.25
    ties = np.concatenate([ties, [31.75, -31.75]]).astype(np.float32)
    rng.shuffle(ties)                       # max 31.75 -> scale 0.25 exactly
    out = {
        "ties": ties.reshape(16, 16),
        "zeros": np.zeros((8, 4), np.float32),
        "small": (rng.randn(128) * 1e-3).astype(np.float32),
        "w": rng.randn(64, 32).astype(np.float32),
        "w3": rng.randn(4, 8, 16).astype(np.float32) * 3.0,
        "bf16": rng.randn(32, 8).astype(np.float32),
    }
    # bf16-exact values, so that both frameworks cast them without rounding
    out["bf16"] = torch.from_numpy(out["bf16"]).bfloat16().float().numpy()
    return out


def to_jax(tree):
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "bf16" else jnp.float32)
            for k, v in tree.items()}


def to_torch(tree):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k == "bf16"
                                      else torch.float32)
            for k, v in tree.items()}


def test_the_ties_are_exact_ties():
    g = leaves()["ties"]
    scale = np.float32(np.abs(g).max()) / np.float32(127.0)
    assert scale == np.float32(0.25)
    frac = np.abs(g / scale) % 1
    assert (frac == 0.5).sum() == g.size - 2


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("with_error_buf", [False, True],
                         ids=["plain", "error_buf"])
def test_codes_and_scales_equal_jax(jit, with_error_buf):
    np_g = leaves()
    cfg, jcfg = optim.CompressionConfig(), joptim.CompressionConfig()
    err = None
    if with_error_buf:
        rng = np.random.RandomState(1)
        err = {k: (rng.randn(*v.shape) * 0.01).astype(np.float32)
               for k, v in np_g.items()}
    jfn = joptim.compress_gradients
    if jit:
        jfn = jax.jit(jfn, static_argnums=1)
    jq, js, jpre = jfn(to_jax(np_g), jcfg,
                       None if err is None else
                       {k: jnp.asarray(v) for k, v in err.items()})
    q, s, pre = optim.compress_gradients(
        to_torch(np_g), cfg,
        None if err is None else {k: torch.from_numpy(v)
                                  for k, v in err.items()})
    for k in np_g:
        assert q[k].dtype == torch.int8 and q[k].shape == np_g[k].shape
        assert s[k].dtype == torch.float32 and s[k].ndim == 0
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]),
                                      err_msg=k)
        want = np.asarray(js[k], np.float32)
        if jit:
            assert abs(s[k].numpy() - want) <= np.spacing(want), k
        else:
            assert s[k].numpy().tobytes() == want.tobytes(), k
        np.testing.assert_array_equal(pre[k].float().numpy(),
                                      np.asarray(jpre[k], np.float32))
    if not with_error_buf:
        # The ties round half to even, as jnp.round does; the all-zero
        # leaf takes the floor of the scale.
        np.testing.assert_array_equal(
            q["ties"].numpy(), np.round(np_g["ties"] / np.float32(0.25)))
        assert not q["zeros"].any()
        assert float(s["zeros"]) == np.float32(1e-12) / np.float32(127.0)


def test_decompress_and_error_feedback_match_jax():
    np_g = leaves()
    q, s, pre = optim.compress_gradients(to_torch(np_g),
                                         optim.CompressionConfig())
    jq, js, jpre = joptim.compress_gradients(to_jax(np_g),
                                             joptim.CompressionConfig())
    deq = optim.decompress_gradients(q, s)
    jdeq = joptim.decompress_gradients(jq, js)
    res = optim.error_feedback_update(pre, deq)
    jres = joptim.error_feedback_update(jpre, jdeq)
    for k in np_g:
        for got, want in ((deq[k], jdeq[k]), (res[k], jres[k])):
            assert got.dtype == torch.float32
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=TOL * max(
                                           float(np.abs(want).max()), 1e-30))


def test_dequantization_error_is_at_most_half_a_step():
    np_g = leaves()
    q, s, _ = optim.compress_gradients(to_torch(np_g),
                                       optim.CompressionConfig())
    deq = optim.decompress_gradients(q, s)
    for k, g in np_g.items():
        e = np.abs(deq[k].double().numpy() - g.astype(np.float64)).max()
        assert e <= float(s[k]) * (0.5 + 2.0 ** -16), k


def test_grad_compression_roundtrip_and_error_feedback():
    """The twin of tests/test_system.py's test of the same name."""
    rng = np.random.RandomState(0)
    grads = {"a": torch.from_numpy(rng.randn(64, 32).astype(np.float32)),
             "b": torch.from_numpy(rng.randn(128).astype(np.float32) * 1e-3)}
    ccfg = optim.CompressionConfig()
    q, s, pre = optim.compress_gradients(grads, ccfg)
    deq = optim.decompress_gradients(q, s)
    for k in grads:
        assert q[k].dtype == torch.int8
        rel = float((deq[k] - grads[k]).abs().max() / grads[k].abs().max())
        assert rel < 0.02, f"{k}: int8 error {rel}"
    # error feedback: residual + dequantized == original
    resid = optim.error_feedback_update(pre, deq)
    for k in grads:
        np.testing.assert_allclose((deq[k] + resid[k]).numpy(),
                                   grads[k].numpy(), rtol=1e-5, atol=1e-6)


def test_error_feedback_carries_the_residual_into_the_next_step():
    """Two steps with the buffer: what the first step lost is quantized in
    the second, as in the reference's use (error_buf = last residual)."""
    np_g = leaves()
    cfg, jcfg = optim.CompressionConfig(), joptim.CompressionConfig()
    g, jg = to_torch(np_g), to_jax(np_g)
    q, s, pre = optim.compress_gradients(g, cfg)
    res = optim.error_feedback_update(pre, optim.decompress_gradients(q, s))
    jq, js, jpre = joptim.compress_gradients(jg, jcfg)
    jres = joptim.error_feedback_update(jpre,
                                        joptim.decompress_gradients(jq, js))
    q2, s2, _ = optim.compress_gradients(g, cfg, res)
    jq2, js2, _ = joptim.compress_gradients(jg, jcfg, jres)
    for k in np_g:
        np.testing.assert_array_equal(q2[k].numpy(), np.asarray(jq2[k]))
        assert float(s2[k]) == float(js2[k])


def test_compression_stays_on_the_leaves_device_and_keeps_names():
    g = {"x.y": torch.randn(3, 5, dtype=torch.float64)}
    q, s, pre = optim.compress_gradients(g, optim.CompressionConfig(bits=4))
    assert list(q) == list(s) == ["x.y"]
    assert q["x.y"].device == g["x.y"].device
    assert int(q["x.y"].abs().max()) == 7            # qmax of 4 bits
    assert pre is g


def test_scales_are_the_quotient_not_the_reciprocal_product():
    """Why the port is held to the eager function: under jax.jit the scale
    is max * fp32(1/qmax), which differs from max / qmax for some maxes
    (CUDA does the same for a Python-number divisor, which the port
    avoids).  Leaves whose largest magnitudes are such maxes: the port's
    scales are the true quotients, the eager reference's too."""
    rng = np.random.RandomState(3)
    m = np.abs(rng.randn(512).astype(np.float32)) + np.float32(1e-3)
    recip = m * np.float32(1 / 127)
    quot = m / np.float32(127)
    assert (recip != quot).sum() >= 5
    tree = {f"l{i}": np.array([v, -v / 3], np.float32)
            for i, v in enumerate(m)}
    _, s, _ = optim.compress_gradients(
        {k: torch.from_numpy(v) for k, v in tree.items()},
        optim.CompressionConfig())
    _, js, _ = joptim.compress_gradients(
        {k: jnp.asarray(v) for k, v in tree.items()},
        joptim.CompressionConfig())
    got = np.array([float(s[f"l{i}"]) for i in range(len(m))], np.float32)
    want = np.array([float(js[f"l{i}"]) for i in range(len(m))], np.float32)
    np.testing.assert_array_equal(got, quot)
    np.testing.assert_array_equal(want, quot)
    jitted = np.asarray(jax.jit(
        lambda x: jnp.maximum(x, 1e-12) / 127.0)(jnp.asarray(m)))
    np.testing.assert_array_equal(jitted, recip)
