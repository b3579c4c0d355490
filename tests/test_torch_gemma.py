"""The port's gemma2-2b, gemma3-4b and minicpm-2b (smoke size) against the
JAX package, on the CPU.

The smoke configs keep each model's knobs: gemma2's alternating local
(window 32 here) and global attention with softcaps 50 and 30, pre and
post norms and the √d embedding scale; gemma3's five local layers to one
global, its dual rope theta (local 10k, global 1M), qk-norm, and 1 period
plus 4 remainder layers (the ``rem{r}`` leaves of the parameter and cache
trees); minicpm's μP scaling (embedding x12, depth-scaled residuals,
logits divided by d/256) over MHA.  As in tests/test_torch_model.py the
JAX parameters are flattened to numpy leaves and carried into the port by
``repro_torch.convert``; both packages then see the same tokens.  Model
tolerances are fp32 1e-4.  Prompts of 48 tokens are longer than the
window, so the local layers mask keys in the prefill.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import ckpt as jckpt  # noqa: E402
from repro.ckpt.shards import _flatten  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import storage as jstorage  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import ckpt, convert  # noqa: E402
from repro_torch.ckpt import shards  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import FileStore  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm, smoke  # noqa: E402
# The checkpoint and train-step harnesses of the llama/xLSTM/Jamba tests,
# taken as they are for these configs; chip_smoke's parameter count.
import chip_smoke  # noqa: E402
from test_torch_ckpt import HOSTS, commit, jax_state, port_state  # noqa: E402
from test_torch_train_step import step_errors  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["gemma2-2b", "gemma3-4b", "minicpm-2b"]
PROMPT_LEN, DECODE_STEPS, MAX_LEN = 48, 4, 64


def build(arch, **changes):
    jcfg = dataclasses.replace(jmc.smoke(jget_config(arch)), **changes)
    cfg = dataclasses.replace(smoke(get_config(arch)), **changes)
    jparams = jlm.init_model(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(cfg, _flatten(jparams), device="cpu")
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module", params=ARCHS)
def built(request):
    return (request.param,) + build(request.param)


def tokens(seed, B, S, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def flat_cache(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_cache(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS + ["gemma2_2b", "gemma3_4b",
                                          "minicpm_2b"])
def test_config_matches_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(smoke(get_config(arch))) == \
        dataclasses.asdict(jmc.smoke(jget_config(arch)))
    assert get_config(arch).param_count() == jget_config(arch).param_count()


def test_full_width_parameter_counts():
    """The parameter elements the card holds at full width and full depth
    (the specs' leaves, counted without allocating) beside ``param_count``,
    copied as it stands: it counts three norms a layer where the specs hold
    two, and no post norms (gemma's four a layer)."""
    want = {"gemma2-2b": (2_614_341_888, 2_614_281_984),
            "gemma3-4b": (3_880_099_328, 3_880_012_288),
            "minicpm-2b": (2_725_173_504, 2_725_265_664)}
    for arch, (elements, counted) in want.items():
        cfg = get_config(arch)
        assert chip_smoke.spec_elements(cfg) == elements, arch
        assert cfg.param_count() == counted, arch
        norms = (2 + 2 * cfg.post_norm) * cfg.d_model * cfg.n_layers
        assert counted - elements == \
            cfg.n_layers * 3 * cfg.d_model - norms, arch


def test_convert_covers_every_parameter_and_round_trips(built):
    """Every JAX leaf lands once, the remainder layers' ``rem{r}`` leaves
    and the post/qk norms included, and ``numpy_from_params`` gives the
    JAX keys and arrays back."""
    arch, jcfg, jparams, cfg, model = built
    flat = _flatten(jparams)
    assert len(list(model.parameters())) == \
        sum(a.shape[0] if k.startswith("layers/") else 1
            for k, a in flat.items())
    back = convert.numpy_from_params(model)
    assert list(back) == list(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    rems = sorted({k.split("/")[0] for k in flat if k.startswith("rem")})
    assert rems == [f"rem{r}" for r in range(cfg.remainder_layers)]
    if arch == "gemma3-4b":
        assert rems == ["rem0", "rem1", "rem2", "rem3"]
        period = len(cfg.pattern)
        np.testing.assert_array_equal(
            model.layers[period + 2].mixer.q_norm.detach().numpy(),
            flat["rem2/mixer/q_norm"])
        np.testing.assert_array_equal(
            model.layers[period + 3].ffn.post_ln.detach().numpy(),
            flat["rem3/ffn/post_ln"])
        for leaf in ("mixer/q_norm", "mixer/k_norm", "mixer/post_ln",
                     "ffn/post_ln"):
            assert f"layers/p0/{leaf}" in flat and f"rem0/{leaf}" in flat
        with pytest.raises(KeyError, match="exactly once"):
            convert.params_from_numpy(cfg, {k: v for k, v in flat.items()
                                            if k != "rem1/mixer/k_norm"},
                                      device="cpu")
    elif arch == "gemma2-2b":
        assert "layers/p0/mixer/post_ln" in flat
        assert "layers/p1/ffn/post_ln" in flat
    else:
        assert not any("post_ln" in k or "q_norm" in k for k in flat)


def test_rope_tables_and_windows_per_kind(built):
    """One rope table per theta the attention kinds use (two for gemma3),
    and each layer's Ctx takes its kind's window and table."""
    arch, _, _, cfg, model = built
    ropes = model.rope(lm.text_positions(1, 5))
    want = {"gemma2-2b": [10_000.0], "gemma3-4b": [10_000.0, 1_000_000.0],
            "minicpm-2b": [10_000.0]}[arch]
    assert sorted(ropes) == want
    for kind in cfg.full_pattern:
        ctx = model.layer_ctx(kind, ropes, mode="prefill")
        local = kind == "attn_local"
        assert ctx.window == (cfg.window if local else 0)
        theta = cfg.local_rope_theta if local and cfg.local_rope_theta \
            else cfg.rope_theta
        assert ctx.rope is ropes[theta]


# ---------------------------------------------------------------------------
# The model against the JAX package
# ---------------------------------------------------------------------------
FWD_TOKENS = tokens(0, 2, PROMPT_LEN)
FWD_LABELS = FWD_TOKENS.copy()
FWD_LABELS[1, :4] = -1                                   # masked labels
PROMPT, FOLLOW = tokens(2, 2, PROMPT_LEN), tokens(3, 2, DECODE_STEPS)


@pytest.fixture(scope="module")
def jax_runs(built):
    """The JAX package's forward, and its prefill plus decode steps, once
    for both of the port's paths."""
    _, jcfg, jparams, _, _ = built
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
def test_forward_matches_jax(plain, built, jax_runs):
    _, _, _, cfg, model = built
    jloss, jlogits = jax_runs[0]
    model.plain_kernels = plain
    try:
        loss, logits = model({"tokens": torch.from_numpy(FWD_TOKENS),
                              "labels": torch.from_numpy(FWD_LABELS)})
    finally:
        model.plain_kernels = False
    assert logits.shape == (2, PROMPT_LEN, cfg.padded_vocab)
    close(logits, jlogits)
    close(loss, jloss)


@pytest.mark.parametrize("plain", [False, True], ids=["ops", "plain"])
def test_prefill_and_decode_match_jax(plain, built, jax_runs):
    """Prefill of 48 tokens (past the window of 32) and 4 decode steps:
    logits after each, and every cache leaf (``rem{r}`` included) after
    the prefill and after the last step."""
    _, _, _, cfg, model = built
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
        if cfg.remainder_layers:
            assert {k.split("/")[0] for k in flat_cache(cache)} == \
                {"layers"} | {f"rem{r}" for r in range(cfg.remainder_layers)}
        for t in range(DECODE_STEPS):
            logits, cache = model.decode_step(
                {"tokens": torch.from_numpy(FOLLOW[:, t:t + 1])}, cache,
                PROMPT_LEN + t)
            close(logits, steps[t + 1][0])
        same_cache(cache, steps[-1][1])
    finally:
        model.plain_kernels = False


def test_plain_and_kernel_paths_agree_on_cpu(built):
    """With CPU tensors ``ops`` takes ``ref.attention_ref``, the plain
    path ``layers.attention``: the same function, windows included."""
    _, _, _, _, model = built
    batch = {"tokens": torch.from_numpy(FWD_TOKENS),
             "labels": torch.from_numpy(FWD_TOKENS)}
    _, via_ops = model(batch)
    _, plain = model(batch, plain=True)
    torch.testing.assert_close(via_ops, plain, rtol=1e-5, atol=1e-5)


def test_the_window_and_the_local_theta_change_the_logits():
    """At 48 tokens gemma2's window of 32 masks keys, and gemma3's local
    theta differs from its global one: dropping either moves the logits,
    so the parity above holds them."""
    toks = {"tokens": torch.from_numpy(FWD_TOKENS),
            "labels": torch.from_numpy(FWD_TOKENS)}
    for arch, change in (("gemma2-2b", dict(window=0)),
                         ("gemma3-4b", dict(local_rope_theta=None))):
        _, jparams, cfg, model = build(arch)
        other = convert.params_from_numpy(
            dataclasses.replace(cfg, **change), _flatten(jparams),
            device="cpu")
        with torch.no_grad():
            _, want = model(toks)
            _, got = other(toks)
        assert float((got - want).abs().max()) > 1e-3, arch


def test_greedy_generate_matches_jax(built):
    _, jcfg, jparams, cfg, model = built
    prompts = tokens(6, 3, 40)
    want = jserve.generate(jcfg, jparams, jnp.asarray(prompts),
                           jserve.ServeConfig(max_new_tokens=10, max_len=64))
    got = serve.generate(cfg, model, prompts,
                         serve.ServeConfig(max_new_tokens=10, max_len=64),
                         device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--batch", "2", "--max-new", "4"]) == 12
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Training and checkpoints
# ---------------------------------------------------------------------------
def test_gemma2_train_step_matches_jax():
    """One fp32 AdamW step from the same weights and batch, at step 0 (lr
    0) and step 1: loss, every gradient leaf, the parameters and both
    moments within 2e-5 of each leaf's largest value."""
    arch = "gemma2-2b"
    jcfg, cfg = jmc.smoke(jget_config(arch)), smoke(get_config(arch))
    report = step_errors(arch, jcfg, cfg,
                         jlm.init_model(jcfg, jax.random.key(0)))
    assert max(report.values()) <= 2e-5, report


def test_gemma3_epochs_restore_across_the_packages(tmp_path):
    """A Cornus epoch of the gemma3 smoke state (parameters with the
    remainder layers' leaves, and both moments) committed by either
    package restores in the other, leaf for leaf."""
    arch = "gemma3-4b"
    jstate = jax_state(arch)
    commit(True, jstorage.FileStore(str(tmp_path / "jax")), jstate, 7)
    store = FileStore(str(tmp_path / "jax"))
    assert ckpt.latest_committed(store, HOSTS) == 7
    state = port_state(arch)
    ckpt.restore_params(store, HOSTS, 7, state)
    got, want = shards._flatten(state), jckpt.shards._flatten(jstate)
    assert list(got) == list(want)
    assert any(k.startswith("params/rem3/") for k in want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    state = port_state(arch, seed=4)
    commit(False, FileStore(str(tmp_path / "port")), state, 4)
    jstore = jstorage.FileStore(str(tmp_path / "port"))
    assert jckpt.latest_committed(jstore, HOSTS) == 4
    restored = jckpt.restore_params(jstore, HOSTS, 4,
                                    jax_state(arch, seed=5))
    got, want = jckpt.shards._flatten(restored), shards._flatten(state)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
