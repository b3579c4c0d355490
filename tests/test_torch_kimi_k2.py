"""The port's kimi-k2-1t-a32b (smoke size) against the JAX package, on the
CPU.

The smoke config keeps kimi-k2's shape of layer: an MoE FFN on every layer
(8 experts top-2 here, 384 top-8 published) with one shared expert beside
the routed ones (the ``ws_*`` leaves, which no other ported config has),
GQA and an untied head.  As in tests/test_torch_qwen3_moe.py the JAX
parameters are flattened to numpy leaves and carried into the port by
``repro_torch.convert``.  Model tolerances are fp32 2e-5; the routers'
expert choices must be equal.  The same model at kimi's own head dim of
112 (``dataclasses.replace(smoke(cfg), head_dim=112)``) holds the plain
attention path there, and the full-width reckoning of the card's cuts
(chip_smoke.py phases 22-23) is checked from the specs.
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
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init_model, layers, moe, smoke  # noqa: E402
import chip_smoke  # noqa: E402
from test_torch_gemma import flat_cache, tokens  # noqa: E402
from test_torch_train_step import step_errors  # noqa: E402

ARCH = "kimi-k2-1t-a32b"
PROMPT_LEN, DECODE_STEPS, MAX_LEN = 24, 4, 32
TOL = dict(rtol=2e-5, atol=2e-5)     # fp32 (tests/test_kernels.py:28)


def close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def both(jcfg, cfg):
    jparams = jlm.init_model(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(cfg, _flatten(jparams), device="cpu")
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module", params=[16, 112], ids=["smoke", "hd112"])
def kimi(request):
    """smoke(kimi-k2) as the reference makes it (head dim 16), and the same
    model at kimi's head dim of 112."""
    hd = request.param
    return both(dataclasses.replace(jmc.smoke(jget_config(ARCH)),
                                    head_dim=hd),
                dataclasses.replace(smoke(get_config(ARCH)), head_dim=hd))


@pytest.mark.parametrize("arch", [ARCH, "kimi_k2_1t_a32b"])
def test_config_matches_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(smoke(get_config(arch))) == \
        dataclasses.asdict(jmc.smoke(jget_config(arch)))
    assert get_config(arch).param_count() == jget_config(arch).param_count()
    assert "kimi_k2_1t_a32b" in ARCH_IDS and get_config(arch).hd == 112


def test_full_width_elements_of_the_card_cuts():
    """A layer is 17.07 G elements (384 experts x 3 x 7,168 x 2,048, the
    shared expert, the router, attention at 64/8 heads of 112, norms); the
    untied embedding and head 2.35 G.  So 1 of 61 layers in fp32 is
    77.7 GB and 2 layers in bf16 73.0 GB: the cuts of phases 22 and 23."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=1)
    layer = chip_smoke.spec_elements(cfg, layers_only=True)
    d, f = 7168, 2048
    experts, shared, router = 384 * 3 * d * f, 3 * d * f, d * 384
    attn = d * 64 * 112 * 2 + d * 8 * 112 * 2
    assert layer == experts + shared + router + attn + 2 * d
    assert chip_smoke.spec_elements(cfg) - layer == \
        2 * cfg.padded_vocab * d + d
    assert layer / 1e9 == pytest.approx(17.07, abs=0.005)
    assert 4 * chip_smoke.spec_elements(cfg) / 1e9 == pytest.approx(
        77.7, abs=0.05)
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    assert 2 * chip_smoke.spec_elements(cfg2) / 1e9 == pytest.approx(
        73.0, abs=0.05)
    assert chip_smoke.KIMI_FP32_LAYERS == 1
    assert chip_smoke.KIMI_SERVE_LAYERS == 2


def test_only_kimis_expert_leaves_are_drawn_in_slices():
    """Of every config's leaves only kimi-k2's three expert leaves (5.64 G
    elements each) are above ``SLICED_DRAW_ELEMENTS``; the largest other
    leaf is qwen2-vl's embedding (1.25 G), so every other model keeps its
    weights."""
    from repro_torch.models.lm import model_specs

    def leaves(tree, path=""):
        if isinstance(tree, layers.PSpec):
            yield path, tree
        else:
            items = tree.items() if isinstance(tree, dict) else \
                enumerate(tree)
            for k, v in items:
                yield from leaves(v, f"{path}/{k}")

    over = {}
    largest_other = 0
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_config(arch), n_layers=1) \
            if arch == "kimi_k2_1t_a32b" else get_config(arch)
        for path, spec in leaves(model_specs(cfg)):
            n = int(np.prod(spec.shape))
            if n > layers.SLICED_DRAW_ELEMENTS:
                over[(arch, path.split("/")[-1])] = n
            else:
                largest_other = max(largest_other, n)
    assert over == {("kimi_k2_1t_a32b", name): 384 * 7168 * 2048
                    for name in moe.EXPERT_LEAVES}
    assert largest_other == get_config("qwen2-vl-72b").padded_vocab * 8192


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_tensor_draws_as_before_below_the_threshold(dtype):
    """A leaf at or under the threshold gets the numbers of one fp32 draw
    of the whole leaf, scaled, then cast, into ``out`` or a new tensor."""
    spec = layers.PSpec((8, 33, 17), (None, None, None))
    want = torch.randn(spec.shape, generator=torch.Generator().manual_seed(
        5)).mul_(spec.stddev()).to(dtype)
    got = layers.init_tensor(spec, torch.Generator().manual_seed(5),
                             dtype=dtype, device="cpu")
    assert got.dtype == dtype and torch.equal(got, want)
    out = torch.empty(spec.shape, dtype=dtype)
    assert layers.init_tensor(spec, torch.Generator().manual_seed(5),
                              dtype=dtype, device="cpu", out=out) is out
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_tensor_draws_a_huge_leaf_slice_by_slice(dtype, monkeypatch):
    """Above the threshold (lowered here) the leaf is drawn one leading
    row at a time from the same generator, each slice in fp32 then cast:
    the same distribution.  (Whether the slices' numbers are the whole
    draw's depends on the generator: the CPU's stream is sequential, the
    card's Philox draws are not.)"""
    monkeypatch.setattr(layers, "SLICED_DRAW_ELEMENTS", 1000)
    spec = layers.PSpec((6, 64, 32), (None, None, None))
    gen = torch.Generator().manual_seed(7)
    want = torch.stack([torch.randn((64, 32), generator=gen).mul_(
        spec.stddev()).to(dtype) for _ in range(6)])
    got = layers.init_tensor(spec, torch.Generator().manual_seed(7),
                             dtype=dtype, device="cpu")
    assert torch.equal(got, want)
    assert abs(float(got.float().std()) - spec.stddev()) < 0.01


def test_convert_covers_every_parameter_and_round_trips(kimi):
    """Every layer's routed experts, router and shared expert
    (``ffn/moe/ws_*``) and the untied ``unembed`` land once and come
    back."""
    _, jparams, cfg, model = kimi
    flat = _flatten(jparams)
    for leaf in ("router", "w_gate", "ws_gate", "ws_up", "ws_down"):
        assert f"layers/p0/ffn/moe/{leaf}" in flat
    assert "unembed" in flat
    back = convert.numpy_from_params(model)
    assert list(back) == list(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


FWD_TOKENS = tokens(0, 2, PROMPT_LEN)
FWD_LABELS = FWD_TOKENS.copy()
FWD_LABELS[1, :4] = -1
PROMPT, FOLLOW = tokens(2, 2, PROMPT_LEN), tokens(3, 2, DECODE_STEPS)


@pytest.fixture(scope="module")
def jax_runs(kimi):
    jcfg, jparams, _, _ = kimi
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
def test_forward_matches_jax(plain, kimi, jax_runs):
    """Train mode: logits and the loss, which carries the routers' aux."""
    _, _, cfg, model = kimi
    jloss, jlogits = jax_runs[0]
    loss, logits = model({"tokens": torch.from_numpy(FWD_TOKENS),
                          "labels": torch.from_numpy(FWD_LABELS)},
                         plain=plain)
    assert logits.shape == (2, PROMPT_LEN, cfg.padded_vocab)
    close(logits, jlogits)
    close(loss, jloss)


@pytest.mark.parametrize("plain", [False, True], ids=["ops", "plain"])
def test_prefill_and_decode_match_jax(plain, kimi, jax_runs):
    """Prefill and 4 decode steps (capacity max(k, 1.25·2·2/8) = 2 an
    expert at decode): logits after each, and every cache leaf after the
    prefill and after the last step."""
    _, _, _, model = kimi
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


def test_expert_choices_equal_jax(kimi, monkeypatch):
    """Every router call of the forward picks the same experts for every
    token in both packages (the JAX model runs eagerly under
    ``disable_jit`` so that its choices can be recorded)."""
    jcfg, jparams, _, model = kimi
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


def test_shared_expert_is_part_of_the_output(kimi):
    """Zeroing the shared expert's down projection changes the MoE output
    by its branch exactly: the ``ws_*`` path runs."""
    _, _, cfg, model = kimi
    p = model.layers[0]["ffn"]["moe"]
    x = torch.from_numpy(np.random.RandomState(4).randn(
        2, 5, cfg.d_model).astype(np.float32))
    with torch.no_grad():
        out, _ = moe.moe_apply(cfg, p, x)
        h = torch.nn.functional.silu(x @ p["ws_gate"]) * (x @ p["ws_up"])
        shared = h @ p["ws_down"]
        saved = p["ws_down"].clone()
        p["ws_down"].zero_()
        try:
            routed, _ = moe.moe_apply(cfg, p, x)
        finally:
            p["ws_down"].copy_(saved)
    assert float(shared.abs().max()) > 1e-3
    torch.testing.assert_close(out, routed + shared, rtol=2e-5, atol=2e-5)


def test_greedy_generate_matches_jax(kimi):
    jcfg, jparams, cfg, model = kimi
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
    largest value; the shared expert's leaves among them."""
    jcfg, cfg = jmc.smoke(jget_config(ARCH)), smoke(get_config(ARCH))
    report = step_errors(ARCH, jcfg, cfg,
                         jlm.init_model(jcfg, jax.random.key(0)))
    assert max(report.values()) <= 2e-5, report


def test_init_model_draws_kimis_smoke_config():
    """The port's own init of the smoke config (as the card phases draw
    the full one): every leaf finite, the normal leaves at their spec's
    scale."""
    cfg = smoke(get_config(ARCH))
    model = init_model(cfg, 0, device="cpu")
    for param, spec in model.named_specs():
        assert torch.isfinite(param).all()
        if spec.init == "normal" and param.numel() >= 4096:
            assert abs(float(param.detach().std()) / spec.stddev() - 1) < 0.1
