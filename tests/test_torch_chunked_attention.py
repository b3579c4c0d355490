"""The port's chunked attention (``layers._chunked_attention`` and the switch
in ``layers.attention``) against the JAX package's, on the CPU.

Both packages read ``CHUNK_THRESHOLD``, ``Q_CHUNK`` and ``KV_CHUNK`` at call
time, so the tests set them small in both modules (threshold 64, chunks of
16 queries and 24 keys) with ``monkeypatch``; the reference's file does not
change.  Inputs are seeded numpy arrays, cast to bf16 the same way on both
sides for the bf16 cases.  Tolerances: fp32 2e-5, bf16 3e-2 (the kernel
tolerances).  One unpatched case runs just above the real threshold of
8,192 tokens at tiny widths.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.shards import _flatten  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import smoke  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SMALL = dict(CHUNK_THRESHOLD=64, Q_CHUNK=16, KV_CHUNK=24)

# (B, S, T, Nq, Nkv, hd, causal, window, cap, q_offset, kv_len); S and T
# ragged against the chunks of 16 and 24 (but for "mha_causal"'s S).
CASES = {
    "mha_causal": (1, 96, 90, 2, 2, 16, True, 0, 0.0, 0, None),
    "gqa_window_softcap_offset": (2, 80, 150, 4, 2, 16, True, 40, 30.0, 70,
                                  None),
    "kv_len_in_padded_chunk": (2, 70, 100, 4, 2, 16, False, 0, 0.0, 0, 98),
    "causal_kv_len_mid_chunk": (1, 70, 100, 4, 2, 8, True, 0, 0.0, 15, 81),
    "noncausal_mha_softcap": (1, 66, 47, 2, 2, 8, False, 0, 50.0, 0, None),
}


@pytest.fixture
def small_chunks(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(jl, name, value)
        monkeypatch.setattr(tl, name, value)


def inputs(case, dtype, seed=0):
    B, S, T, Nq, Nkv, hd = case[:6]
    rng = np.random.RandomState(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Nq, hd), (B, T, Nkv, hd), (B, T, Nkv, hd))]
    jx = [jnp.asarray(a).astype(JDT[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    return jx, tx


def attend(case, jx, tx):
    causal, window, cap, q_offset, kv_len = case[6:]
    kw = dict(causal=causal, window=window, cap=cap, q_offset=q_offset,
              kv_len=kv_len)
    return jl.attention(*jx, **kw), tl.attention(*tx, **kw)


def close(got, want, dtype):
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_chunked_attention_matches_jax(small_chunks, name, dtype,
                                       monkeypatch):
    case = CASES[name]
    calls = []
    chunked = tl._chunked_attention
    monkeypatch.setattr(tl, "_chunked_attention",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    jx, tx = inputs(case, dtype)
    want, got = attend(case, jx, tx)
    assert calls == [1], "the switch did not take the chunked path"
    close(got, want, dtype)


@pytest.mark.parametrize("name", ["gqa_window_softcap_offset",
                                  "causal_kv_len_mid_chunk"])
def test_chunked_attention_called_directly(small_chunks, name):
    """The two ``_chunked_attention``s on the same scaled, grouped queries."""
    case = CASES[name]
    B, S, T, Nq, Nkv, hd, causal, window, cap, q_offset, kv_len = case
    jx, tx = inputs(case, "float32", seed=3)
    kw = dict(causal=causal, window=window, cap=cap, q_offset=q_offset,
              kv_len=kv_len)
    jqg = (jx[0] * (1.0 / np.sqrt(hd))).reshape(B, S, Nkv, Nq // Nkv, hd)
    tqg = (tx[0] * (1.0 / np.sqrt(hd))).reshape(B, S, Nkv, Nq // Nkv, hd)
    close(tl._chunked_attention(tqg, tx[1], tx[2], **kw),
          jl._chunked_attention(jqg, jx[1], jx[2], **kw), "float32")


@pytest.mark.parametrize("name", ["gqa_window_softcap_offset",
                                  "causal_kv_len_mid_chunk", "mha_causal"])
def test_chunked_equals_the_unchunked_port(small_chunks, name, monkeypatch):
    """Above the threshold and below it (threshold raised), the port's two
    paths give one function."""
    case = CASES[name]
    _, tx = inputs(case, "float32", seed=5)
    causal, window, cap, q_offset, kv_len = case[6:]
    kw = dict(causal=causal, window=window, cap=cap, q_offset=q_offset,
              kv_len=kv_len)
    chunked = tl.attention(*tx, **kw)
    monkeypatch.setattr(tl, "CHUNK_THRESHOLD", 10 ** 6)
    np.testing.assert_allclose(chunked.numpy(), tl.attention(*tx, **kw)
                               .numpy(), rtol=2e-5, atol=2e-5)


def test_switch_is_at_the_threshold_and_decode_never_chunks(small_chunks,
                                                            monkeypatch):
    calls = []
    chunked = tl._chunked_attention
    monkeypatch.setattr(tl, "_chunked_attention",
                        lambda *a, **k: calls.append(a[0].shape[1])
                        or chunked(*a, **k))
    for S in (64, 65):
        _, tx = inputs((1, S, S, 2, 1, 8), "float32")
        tl.attention(*tx)
    _, tx = inputs((1, 1, 300, 2, 1, 8), "float32")
    tl.attention(*tx, causal=False, q_offset=299, kv_len=300)
    assert calls == [65]
    assert (tl.CHUNK_THRESHOLD, tl.Q_CHUNK, tl.KV_CHUNK) == (64, 16, 24)


def test_default_constants_are_the_references():
    assert (tl.CHUNK_THRESHOLD, tl.Q_CHUNK, tl.KV_CHUNK) == \
        (jl.CHUNK_THRESHOLD, jl.Q_CHUNK, jl.KV_CHUNK) == (8192, 2048, 2048)


def test_just_above_the_real_threshold():
    """8,200 causal queries, unpatched: five query chunks (the last of 8
    rows) against five key chunks, in both packages."""
    case = (1, 8200, 8200, 2, 1, 8, True, 0, 0.0, 0, None)
    assert case[1] > tl.CHUNK_THRESHOLD
    jx, tx = inputs(case, "float32", seed=7)
    want, got = attend(case, jx, tx)
    close(got, want, "float32")


def test_lm_forward_above_the_threshold_matches_jax(small_chunks):
    """The smoke llama's plain forward on 2 x 80 tokens, every attention
    layer chunked, against the JAX model's loss and logits."""
    jcfg = jmc.smoke(jget_config("llama3.2-1b"))
    cfg = smoke(get_config("llama3.2-1b"))
    jparams = jlm.init_model(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(cfg, _flatten(jparams), device="cpu")
    toks = np.random.RandomState(11).randint(0, 512, (2, 80)).astype(
        np.int32)
    assert toks.shape[1] > tl.CHUNK_THRESHOLD
    jloss, jlogits = jlm.forward(jcfg, jparams, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    with torch.no_grad():
        loss, logits = model({"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(toks)}, plain=True)
    close(logits, jlogits, "float32")
    close(loss, jloss, "float32")
