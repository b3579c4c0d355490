"""The port's jamba-v0.1-52b (smoke size) against the JAX package, on the CPU.

The smoke config keeps Jamba's pattern (seven mamba layers and one
attention layer a period, MoE on odd layers) over 16 layers, 2 periods, at
d_model 64.  As in tests/test_torch_model.py the JAX parameters are
flattened to numpy leaves (``ffn/moe/...`` nests one level deeper) and
carried into the port by ``repro_torch.convert``; both packages then see the
same tokens.  Model tolerances are fp32 1e-4; every cache leaf is compared.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.shards import _flatten  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (blocks, init_cache, layer_cache, lm,  # noqa: E402
                                smoke)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "jamba-v0.1-52b"


def build(**changes):
    jcfg = dataclasses.replace(jmc.smoke(jget_config(ARCH)), **changes)
    cfg = dataclasses.replace(smoke(get_config(ARCH)), **changes)
    jparams = jlm.init_model(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(cfg, _flatten(jparams), device="cpu")
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def jamba():
    return build()


def tokens(seed, B, S, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def flat_cache(tree, prefix=""):
    """The port's cache tree as ``/``-joined keys, like ``_flatten``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_cache(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def randn(seed, shape, scale=1.0):
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# Config, specs, conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [ARCH, "jamba_v0_1_52b"])
def test_config_matches_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(smoke(get_config(arch))) == \
        dataclasses.asdict(jmc.smoke(jget_config(arch)))
    # The copied count, quirk included (ROADMAP Queue 3): its mamba term
    # differs from what mamba_specs holds.
    assert get_config(arch).param_count() == \
        jget_config(arch).param_count() == 51_448_991_744


def test_full_width_parameter_count():
    """jamba-v0.1-52b holds 51,570,085,888 parameters at its published
    depth and 26,053,480,448 in the 2 of 4 periods that chip_smoke.py
    serves (the JAX specs' counts); no tensor is allocated."""
    def count(cfg):
        specs = lm.model_specs(cfg)
        total = sum(math.prod(s.shape) for k, s in specs.items()
                    if k != "layers")

        def walk(tree):
            return sum(walk(v) if isinstance(v, dict) else math.prod(v.shape)
                       for v in tree.values())
        return total + sum(walk(layer) for layer in specs["layers"])

    cfg = get_config(ARCH)
    assert count(cfg) == 51_570_085_888
    assert count(dataclasses.replace(cfg, n_layers=16)) == 26_053_480_448
    layer = lm.model_specs(cfg)["layers"][1]
    assert layer["ffn"]["moe"]["w_gate"].shape == (16, 4096, 14336)
    assert layer["mixer"]["a_log"].shape == (8192, 16)


def test_layer_specs_match_jax():
    jcfg, cfg = jmc.smoke(jget_config(ARCH)), smoke(get_config(ARCH))
    for li in range(cfg.n_layers):
        want = _flatten(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape), jblocks.layer_specs(jcfg, li),
            is_leaf=lambda s: hasattr(s, "shape")))
        got = flat_cache(blocks.layer_specs(cfg, li))
        assert sorted(got) == sorted(want), li
        for k, s in got.items():
            assert s.shape == want[k].shape, (li, k)
    assert "moe" in blocks.layer_specs(cfg, 1)["ffn"]
    assert "moe" not in blocks.layer_specs(cfg, 4)["ffn"]


def test_convert_covers_every_nested_leaf(jamba):
    jcfg, jparams, cfg, model = jamba
    flat = _flatten(jparams)
    assert any(k.startswith("layers/p1/ffn/moe/") for k in flat)
    assert len(list(model.parameters())) == \
        sum(a.shape[0] if k.startswith("layers/") else 1
            for k, a in flat.items())
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in flat.values())
    period = len(cfg.pattern)
    np.testing.assert_array_equal(
        model.layers[period + 3].ffn.moe.w_down.detach().numpy(),
        flat["layers/p3/ffn/moe/w_down"][1])
    np.testing.assert_array_equal(model.layers[2].mixer.a_log.detach().numpy(),
                                  flat["layers/p2/mixer/a_log"][0])
    for drop in ("layers/p1/ffn/moe/router", "layers/p0/mixer/conv"):
        with pytest.raises(KeyError, match="exactly once"):
            convert.params_from_numpy(cfg, {k: v for k, v in flat.items()
                                            if k != drop}, device="cpu")
    bad = dict(flat)
    bad["layers/p1/ffn/moe/bias"] = flat["layers/p1/ffn/moe/router"]
    with pytest.raises(KeyError, match="unknown"):
        convert.params_from_numpy(cfg, bad, device="cpu")
    bad = {k: v for k, v in flat.items() if not k.startswith(
        "layers/p1/ffn/moe/")}
    bad["layers/p1/ffn/moe"] = flat["layers/p1/ffn/moe/router"]
    with pytest.raises(KeyError, match="subtree"):
        convert.params_from_numpy(cfg, bad, device="cpu")


def test_init_cache_matches_jax_tree():
    """Mamba layers carry a conv window in the activations' dtype and an
    fp32 SSM state; the attention layer K/V in the activations' dtype."""
    cfg = smoke(get_config(ARCH))
    cache = flat_cache(init_cache(cfg, 2, 8, dtype=torch.bfloat16,
                                  device="cpu"))
    jcache = _flatten(jlm.init_cache(jmc.smoke(jget_config(ARCH)), 2, 8,
                                     dtype=jnp.bfloat16))
    assert sorted(cache) == sorted(jcache)
    for key, t in cache.items():
        assert tuple(t.shape) == jcache[key].shape, key
        want = torch.float32 if key.endswith("/ssm") else torch.bfloat16
        assert t.dtype == want, key
        assert str(jcache[key].dtype) == str(want).split(".")[-1], key


# ---------------------------------------------------------------------------
# The Mamba block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plain", [False, True], ids=["ops", "plain"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mamba_apply_matches_jax(mode, plain, jamba):
    jcfg, jparams, cfg, model = jamba
    B, S = 2, 7 if mode != "decode" else 1
    jx, x = randn(7, (B, S, cfg.d_model))
    jp = jax.tree_util.tree_map(lambda a: a[1],
                                jparams["layers"]["p2"]["mixer"])
    p = model.layers[len(cfg.pattern) + 2].mixer
    di = cfg.ssm_expand * cfg.d_model
    jcache = cache = None
    if mode != "train":
        jconv, conv = randn(8, (B, cfg.ssm_conv - 1, di), 0.5)
        jssm, ssm = randn(9, (B, di, cfg.ssm_state), 0.5)
        jcache = {"conv": jconv, "ssm": jssm}
        cache = {"conv": conv.clone(), "ssm": ssm.clone()}
    jctx = jblocks.Ctx(mode=mode, positions=None, theta=0.0, cache=jcache)
    ctx = blocks.Ctx(mode=mode, cache=cache, plain=plain)
    jout, jnew = jblocks.mamba_apply(jcfg, jp, jx, jctx)
    out, new = blocks.mamba_apply(cfg, p, x, ctx)
    close(out, jout)
    if mode != "train":
        assert new is cache                      # written in place
        assert cache["ssm"].dtype == torch.float32
        for n in ("conv", "ssm"):
            close(cache[n], jnew[n])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
FWD_TOKENS = tokens(0, 2, 16)
FWD_LABELS = FWD_TOKENS.copy()
FWD_LABELS[1, :4] = -1                                   # masked labels
PROMPT, FOLLOW, MAX_LEN = tokens(2, 2, 10), tokens(3, 2, 5), 24


@pytest.fixture(scope="module")
def jax_runs(jamba):
    """The JAX package's forward, and its prefill plus decode steps, once
    for both of the port's paths."""
    jcfg, jparams, _, _ = jamba
    fwd = jlm.forward(jcfg, jparams, {"tokens": jnp.asarray(FWD_TOKENS),
                                      "labels": jnp.asarray(FWD_LABELS)})
    jlogits, jcache, jpos = jlm.prefill(jcfg, jparams,
                                        {"tokens": jnp.asarray(PROMPT)},
                                        MAX_LEN)
    steps = [(jlogits, _flatten(jcache))]
    S = PROMPT.shape[1]
    for t in range(FOLLOW.shape[1]):
        jlogits, jcache = jlm.decode_step(
            jcfg, jparams, {"tokens": jnp.asarray(FOLLOW[:, t:t + 1])},
            jcache, jnp.int32(S + t))
        steps.append((jlogits, _flatten(jcache)))
    return fwd, jpos, steps


@pytest.mark.parametrize("plain", [False, True], ids=["ops", "plain"])
def test_forward_matches_jax(plain, jamba, jax_runs):
    """Train mode: logits and the loss, which carries the routers' aux."""
    jcfg, jparams, cfg, model = jamba
    (jloss, jlogits), _, _ = jax_runs
    toks, toks_lb = FWD_TOKENS, FWD_LABELS
    model.plain_kernels = plain
    try:
        loss, logits = model({"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(toks_lb)})
        _, aux = model.run_layers(
            model.embed_inputs({"tokens": torch.from_numpy(toks)}),
            mode="train", positions=lm.text_positions(2, 16))
    finally:
        model.plain_kernels = False
    assert logits.shape == (2, 16, cfg.padded_vocab)
    assert isinstance(aux, torch.Tensor) and float(aux) > 0
    close(logits, jlogits)
    close(loss, jloss)


@pytest.mark.parametrize("plain", [False, True], ids=["ops", "plain"])
def test_prefill_and_decode_match_jax(plain, jamba, jax_runs):
    """Prefill and 5 decode steps: logits after each, and every cache leaf
    (seven mamba layers' conv and ssm, the attention layer's k and v,
    stacked over 2 periods) after the prefill and after the last step."""
    _, _, cfg, model = jamba
    _, jpos, steps = jax_runs
    S = PROMPT.shape[1]

    def same_cache(cache, jflat):
        flat = flat_cache(cache)
        assert sorted(flat) == sorted(jflat)
        assert len(flat) == 7 * 2 + 2
        for key, t in flat.items():
            close(t, jflat[key])

    model.plain_kernels = plain
    try:
        logits, cache, pos = model.prefill(
            {"tokens": torch.from_numpy(PROMPT)}, MAX_LEN)
        assert pos == jpos == S
        close(logits, steps[0][0])
        same_cache(cache, steps[0][1])
        for t in range(FOLLOW.shape[1]):
            logits, cache = model.decode_step(
                {"tokens": torch.from_numpy(FOLLOW[:, t:t + 1])}, cache,
                S + t)
            close(logits, steps[t + 1][0])
        same_cache(cache, steps[-1][1])
    finally:
        model.plain_kernels = False


def test_decode_matches_forward_hybrid():
    """Teacher-forced decode == train forward logits through mamba + MoE +
    attention (the torch twin of tests/test_arch_smoke.py::
    test_decode_matches_forward_hybrid); capacity_factor 8.0 so no token
    is dropped, since drops legitimately differ between the batched and
    one-token paths."""
    _, _, _, model = build(capacity_factor=8.0)
    B, S = 1, 10
    toks = torch.from_numpy(tokens(6, B, S))
    _, full_logits = model({"tokens": toks, "labels": toks})
    logits, cache, _ = model.prefill({"tokens": toks[:, :5]}, max_len=S)
    outs = [logits]
    for t in range(5, S):
        logits, cache = model.decode_step({"tokens": toks[:, t:t + 1]},
                                          cache, t)
        outs.append(logits)
    dec = torch.cat(outs, dim=1)                 # positions 4..S-1
    torch.testing.assert_close(full_logits[:, 4:], dec, rtol=5e-2, atol=5e-2)


def test_greedy_generate_matches_jax(jamba):
    jcfg, jparams, cfg, model = jamba
    prompts = tokens(6, 3, 8)
    want = jserve.generate(jcfg, jparams, jnp.asarray(prompts),
                           jserve.ServeConfig(max_new_tokens=10, max_len=32))
    got = serve.generate(cfg, model, prompts,
                         serve.ServeConfig(max_new_tokens=10, max_len=32),
                         device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_layer_cache_views_write_the_stacked_cache():
    """A mamba layer's cache is a view of the stacked tensor, so the state
    it writes in place is the model's."""
    cfg = smoke(get_config(ARCH))
    cache = init_cache(cfg, 1, 8, dtype=torch.float32, device="cpu")
    view = layer_cache(cfg, cache, len(cfg.pattern) + 2)
    view["ssm"].fill_(1.0)
    assert float(cache["layers"]["p2"]["ssm"][1].min()) == 1.0
    assert float(cache["layers"]["p2"]["ssm"][0].abs().max()) == 0.0


def test_serve_main_runs_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--batch", "2", "--max-new", "4"]) == 12
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out
