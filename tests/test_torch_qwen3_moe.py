"""The port's qwen3-moe-235b-a22b (smoke size) against the JAX package, on
the CPU.

The smoke config keeps qwen3-moe's shape of layer: an MoE FFN on every
layer (8 experts top-2 here, 128 top-8 published) with no shared expert,
qk-norm, GQA and an untied head.  As in tests/test_torch_gemma.py the JAX
parameters are flattened to numpy leaves and carried into the port by
``repro_torch.convert``.  Model tolerances are fp32 1e-4; the routers'
expert choices must be equal.
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
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe, smoke  # noqa: E402
import chip_smoke  # noqa: E402
from test_torch_gemma import close, flat_cache, tokens  # noqa: E402
from test_torch_train_step import step_errors  # noqa: E402

ARCH = "qwen3-moe-235b-a22b"
PROMPT_LEN, DECODE_STEPS, MAX_LEN = 24, 4, 32


@pytest.fixture(scope="module")
def qwen3():
    jcfg = jmc.smoke(jget_config(ARCH))
    cfg = smoke(get_config(ARCH))
    jparams = jlm.init_model(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(cfg, _flatten(jparams), device="cpu")
    return jcfg, jparams, cfg, model


@pytest.mark.parametrize("arch", [ARCH, "qwen3_moe_235b_a22b"])
def test_config_matches_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(smoke(get_config(arch))) == \
        dataclasses.asdict(jmc.smoke(jget_config(arch)))
    assert get_config(arch).param_count() == jget_config(arch).param_count()


def test_full_width_elements_of_the_card_cut():
    """The 4-layer cut that the card holds in fp32: 2.49 B elements a
    layer (128 experts x 3 x 4,096 x 1,536, the router, attention and
    norms) and 1.25 B in the embedding and head, 44.8 GB in all."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=4)
    layer = chip_smoke.spec_elements(cfg, layers_only=True) // 4
    experts = 128 * 3 * 4096 * 1536
    attn = 4096 * 8192 * 2 + 4096 * 512 * 2
    assert layer == experts + 4096 * 128 + attn + 2 * 128 + 2 * 4096
    assert chip_smoke.spec_elements(cfg) - 4 * layer == \
        2 * cfg.padded_vocab * 4096 + 4096
    assert 4 * chip_smoke.spec_elements(cfg) / 1e9 == pytest.approx(44.8,
                                                                    abs=0.05)


def test_convert_covers_every_parameter_and_round_trips(qwen3):
    """Every layer's MoE leaves (``ffn/moe/...``), the qk norms and the
    untied ``unembed`` land once and come back."""
    _, jparams, cfg, model = qwen3
    flat = _flatten(jparams)
    assert "unembed" in flat and "layers/p0/mixer/q_norm" in flat
    assert "layers/p0/ffn/moe/router" in flat
    back = convert.numpy_from_params(model)
    assert list(back) == list(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


FWD_TOKENS = tokens(0, 2, PROMPT_LEN)
FWD_LABELS = FWD_TOKENS.copy()
FWD_LABELS[1, :4] = -1
PROMPT, FOLLOW = tokens(2, 2, PROMPT_LEN), tokens(3, 2, DECODE_STEPS)


@pytest.fixture(scope="module")
def jax_runs(qwen3):
    jcfg, jparams, _, _ = qwen3
    fwd = jlm.forward(jcfg, jparams, {"tokens": jnp.asarray(FWD_TOKENS),
                                      "labels": jnp.asarray(FWD_LABELS)})
    jlogits, jcache, jpos = jlm.prefill(jcfg, jparams,
                                        {"tokens": jnp.asarray(PROMPT)},
                                        MAX_LEN)
    steps = [(jlogits, _flatten(jcache))]
    for t in range(DECODE_STEPS):
        jlogits, jcache = jlm.decode_step(
            jcfg, jparams, {"tokens": jnp.asarray(FOLLOW[:, t:t + 1])},
            jcache, jnp.int32(PROMPT_LEN + t))
        steps.append((jlogits, _flatten(jcache)))
    return fwd, jpos, steps


@pytest.mark.parametrize("plain", [False, True], ids=["ops", "plain"])
def test_forward_matches_jax(plain, qwen3, jax_runs):
    """Train mode: logits and the loss, which carries the routers' aux."""
    _, _, cfg, model = qwen3
    jloss, jlogits = jax_runs[0]
    loss, logits = model({"tokens": torch.from_numpy(FWD_TOKENS),
                          "labels": torch.from_numpy(FWD_LABELS)},
                         plain=plain)
    assert logits.shape == (2, PROMPT_LEN, cfg.padded_vocab)
    close(logits, jlogits)
    close(loss, jloss)


@pytest.mark.parametrize("plain", [False, True], ids=["ops", "plain"])
def test_prefill_and_decode_match_jax(plain, qwen3, jax_runs):
    """Prefill and 4 decode steps (capacity max(k, 1.25·2·2/8) = 2 an
    expert at decode, so steps can drop): logits after each, and every
    cache leaf after the prefill and after the last step."""
    _, _, _, model = qwen3
    _, jpos, steps = jax_runs

    def same_cache(cache, jflat):
        flat = flat_cache(cache)
        assert sorted(flat) == sorted(jflat)
        for key, t in flat.items():
            close(t, jflat[key])

    model.plain_kernels = plain
    try:
        logits, cache, pos = model.prefill(
            {"tokens": torch.from_numpy(PROMPT)}, MAX_LEN)
        assert pos == jpos == PROMPT_LEN
        close(logits, steps[0][0])
        same_cache(cache, steps[0][1])
        for t in range(DECODE_STEPS):
            logits, cache = model.decode_step(
                {"tokens": torch.from_numpy(FOLLOW[:, t:t + 1])}, cache,
                PROMPT_LEN + t)
            close(logits, steps[t + 1][0])
        same_cache(cache, steps[-1][1])
    finally:
        model.plain_kernels = False


def test_expert_choices_equal_jax(qwen3, monkeypatch):
    """Every router call of the forward, layer by layer, picks the same
    experts for every token in both packages (the JAX scan runs eagerly
    under ``disable_jit`` so that its choices can be recorded)."""
    jcfg, jparams, _, model = qwen3
    got, want = [], []
    real, jreal = moe._route, jmoe._route

    def route(cfg, w, x):
        out = real(cfg, w, x)
        got.append(out[1].numpy())
        return out

    def jroute(cfg, w, x):
        out = jreal(cfg, w, x)
        want.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(moe, "_route", route)
    monkeypatch.setattr(jmoe, "_route", jroute)
    with jax.disable_jit():
        jlm.forward(jcfg, jparams, {"tokens": jnp.asarray(FWD_TOKENS),
                                    "labels": jnp.asarray(FWD_LABELS)})
    with torch.no_grad():
        model({"tokens": torch.from_numpy(FWD_TOKENS),
               "labels": torch.from_numpy(FWD_LABELS)})
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2 * PROMPT_LEN, 2)
        np.testing.assert_array_equal(np.sort(g, -1), np.sort(w, -1))


def test_greedy_generate_matches_jax(qwen3):
    jcfg, jparams, cfg, model = qwen3
    prompts = tokens(6, 3, 20)
    want = jserve.generate(jcfg, jparams, jnp.asarray(prompts),
                           jserve.ServeConfig(max_new_tokens=8, max_len=32))
    got = serve.generate(cfg, model, prompts,
                         serve.ServeConfig(max_new_tokens=8, max_len=32),
                         device="cpu")
    np.testing.assert_array_equal(got, want)


def test_train_step_matches_jax():
    """One fp32 AdamW step from the same weights and batch, at step 0 (lr
    0) and step 1: loss (with the routers' aux term), every gradient
    leaf, the parameters and both moments within 2e-5 of each leaf's
    largest value."""
    jcfg, cfg = jmc.smoke(jget_config(ARCH)), smoke(get_config(ARCH))
    report = step_errors(ARCH, jcfg, cfg,
                         jlm.init_model(jcfg, jax.random.key(0)))
    assert max(report.values()) <= 2e-5, report
