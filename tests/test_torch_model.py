"""The port's llama3.2-1b (smoke size) against the JAX package, on the CPU.

The JAX parameters (``repro.models.init_model``) are flattened to the
``/``-joined numpy leaves of ``repro.ckpt.shards._flatten`` and carried into
the port by ``repro_torch.convert``; both packages then see the same tokens.
Tolerances are fp32 1e-4 (wider than the layers' 1e-5 because the sums over
d_model and the vocab run in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.shards import _flatten  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import smoke  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "llama3.2-1b"
# The llama smoke config with every dense-attention knob of the gemma and
# minicpm configs switched on (each one a branch of attn/ffn/head).
KNOBS = dict(qk_norm=True, post_norm=True, attn_softcap=20.0,
             final_softcap=15.0, embed_scale=8.0, residual_scale=0.7,
             logit_divisor=2.0)


def build(knobs=None):
    jcfg = jmc.smoke(jget_config(ARCH))
    cfg = smoke(get_config(ARCH))
    if knobs:
        jcfg = dataclasses.replace(jcfg, **knobs)
        cfg = dataclasses.replace(cfg, **knobs)
    jparams = jlm.init_model(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(cfg, _flatten(jparams), device="cpu")
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def llama():
    return build()


def tokens(seed, B, S, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("arch", [ARCH, "llama3_2_1b"])
def test_config_matches_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(smoke(get_config(arch))) == \
        dataclasses.asdict(jmc.smoke(jget_config(arch)))
    assert get_config(arch).param_count() == jget_config(arch).param_count()


def test_convert_covers_every_parameter(llama):
    jcfg, jparams, cfg, model = llama
    flat = _flatten(jparams)
    assert len(list(model.parameters())) == \
        sum(a.shape[0] if k.startswith("layers/") else 1
            for k, a in flat.items())
    np.testing.assert_array_equal(model.layers[1].mixer.wq.detach().numpy(),
                                  flat["layers/p0/mixer/wq"][1])
    with pytest.raises(KeyError):
        convert.params_from_numpy(cfg, {k: v for k, v in flat.items()
                                        if k != "final_ln"}, device="cpu")


@pytest.mark.parametrize("knobs", [None, KNOBS], ids=["llama", "knobs"])
def test_forward_matches_jax(knobs, llama):
    jcfg, jparams, cfg, model = llama if knobs is None else build(knobs)
    toks = tokens(0, 2, 16)
    toks_lb = toks.copy()
    toks_lb[0, :3] = -1                                  # masked labels
    jloss, jlogits = jlm.forward(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                                 "labels": jnp.asarray(toks_lb)})
    loss, logits = model({"tokens": torch.from_numpy(toks),
                          "labels": torch.from_numpy(toks_lb)})
    assert logits.shape == (2, 16, cfg.padded_vocab)
    close(logits, jlogits)
    close(loss, jloss)


def test_plain_and_kernel_paths_agree_on_cpu(llama):
    """With CPU tensors ``ops`` takes ``ref.attention_ref``; the plain path
    takes ``layers.attention``; both compute the same function."""
    _, _, _, model = llama
    batch = {"tokens": torch.from_numpy(tokens(1, 2, 12))}
    batch["labels"] = batch["tokens"]
    _, via_ops = model(batch)
    model.plain_kernels = True
    try:
        _, plain = model(batch)
    finally:
        model.plain_kernels = False
    torch.testing.assert_close(via_ops, plain, rtol=1e-5, atol=1e-5)


def test_prefill_and_decode_match_jax(llama):
    jcfg, jparams, cfg, model = llama
    B, S, max_len, steps = 2, 10, 24, 8
    prompt = tokens(2, B, S)
    follow = tokens(3, B, steps)
    jlogits, jcache, jpos = jlm.prefill(jcfg, jparams,
                                        {"tokens": jnp.asarray(prompt)},
                                        max_len)
    logits, cache, pos = model.prefill({"tokens": torch.from_numpy(prompt)},
                                       max_len)
    assert pos == jpos == S
    close(logits, jlogits)
    # The cache tree and layout are the JAX package's.
    jflat = _flatten(jcache)
    assert sorted(jflat) == ["layers/p0/k", "layers/p0/v"]
    close(cache["layers"]["p0"]["k"], jflat["layers/p0/k"])
    close(cache["layers"]["p0"]["v"], jflat["layers/p0/v"])
    for t in range(steps):
        tok = follow[:, t:t + 1]
        jlogits, jcache = jlm.decode_step(jcfg, jparams,
                                          {"tokens": jnp.asarray(tok)},
                                          jcache, jnp.int32(S + t))
        logits, cache = model.decode_step({"tokens": torch.from_numpy(tok)},
                                          cache, S + t)
        close(logits, jlogits)
    close(cache["layers"]["p0"]["k"], _flatten(jcache)["layers/p0/k"])


def test_decode_matches_forward_dense(llama):
    """Teacher-forced decode == train forward logits (the torch twin of
    tests/test_arch_smoke.py::test_decode_matches_forward_dense)."""
    _, _, _, model = llama
    B, S = 1, 12
    toks = torch.from_numpy(tokens(5, B, S))
    _, full_logits = model({"tokens": toks, "labels": toks})
    logits, cache, _ = model.prefill({"tokens": toks[:, :4]}, max_len=S)
    outs = [logits]
    for t in range(4, S):
        logits, cache = model.decode_step({"tokens": toks[:, t:t + 1]},
                                          cache, t)
        outs.append(logits)
    dec = torch.cat(outs, dim=1)                 # positions 3..S-1
    torch.testing.assert_close(full_logits[:, 3:], dec, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("eos", [None, 7], ids=["no_eos", "eos"])
def test_greedy_generate_matches_jax(eos, llama):
    jcfg, jparams, cfg, model = llama
    prompts = tokens(6, 3, 8)
    if eos is not None:
        eos = int(jserve.generate(jcfg, jparams, jnp.asarray(prompts),
                                  jserve.ServeConfig(max_new_tokens=3,
                                                     max_len=32))[0, 1])
    jscfg = jserve.ServeConfig(max_new_tokens=10, max_len=32, eos_id=eos)
    scfg = serve.ServeConfig(max_new_tokens=10, max_len=32, eos_id=eos)
    want = jserve.generate(jcfg, jparams, jnp.asarray(prompts), jscfg)
    got = serve.generate(cfg, model, prompts, scfg, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_sampled_generate_is_seeded_and_respects_top_k(llama):
    _, _, cfg, model = llama
    prompts = tokens(7, 2, 8)
    scfg = serve.ServeConfig(max_new_tokens=6, max_len=32, temperature=0.8,
                             top_k=1, seed=3)
    top1 = serve.generate(cfg, model, prompts, scfg, device="cpu")
    greedy = serve.generate(cfg, model, prompts,
                            serve.ServeConfig(max_new_tokens=6, max_len=32),
                            device="cpu")
    np.testing.assert_array_equal(top1, greedy)     # top-1 sampling = argmax
    scfg = dataclasses.replace(scfg, top_k=50)
    a = serve.generate(cfg, model, prompts, scfg, device="cpu")
    b = serve.generate(cfg, model, prompts, scfg, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < cfg.vocab_size


def test_serve_main_runs_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--requests", "3", "--batch", "2",
                       "--max-new", "4"]) == 12
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out
