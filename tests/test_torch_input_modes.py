"""The port's stub input modes against the JAX package, on the CPU:
qwen2-vl-72b ("mixed": projected patch embeddings before the text tokens,
M-RoPE over three position streams) and musicgen-medium ("embeds":
projected frame embeddings, tied head over its 2,048 codes), at smoke size.

As in tests/test_torch_gemma.py the JAX parameters are flattened to numpy
leaves and carried into the port by ``repro_torch.convert``; both packages
then see the same embeddings and tokens, drawn with numpy.  Model
tolerances are fp32 1e-4; M-RoPE alone is held at the fp32 kernel
tolerance 2e-5 and its positions exactly.
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
from repro.models import config as jmc  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import ckpt, convert  # noqa: E402
from repro_torch.ckpt import shards  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import FileStore  # noqa: E402
from repro_torch.models import layers, smoke  # noqa: E402
# The checkpoint and train-step harnesses of the other model tests.
from test_torch_ckpt import HOSTS, commit, jax_state, port_state  # noqa: E402
from test_torch_gemma import close, flat_cache  # noqa: E402
from test_torch_train_step import batch, step_errors  # noqa: E402

ARCHS = ["qwen2-vl-72b", "musicgen-medium"]
PROMPT_LEN, DECODE_STEPS, MAX_LEN = 24, 4, 32
ROPE_TOL = dict(rtol=2e-5, atol=2e-5)


def build(arch, **changes):
    jcfg = dataclasses.replace(jmc.smoke(jget_config(arch)), **changes)
    cfg = dataclasses.replace(smoke(get_config(arch)), **changes)
    jparams = jlm.init_model(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(cfg, _flatten(jparams), device="cpu")
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module", params=ARCHS)
def built(request):
    return (request.param,) + build(request.param)


def prompt(cfg, seed, B, S):
    """``batch``'s inputs without the labels: S frame embeddings, or the
    patch/text split of the JAX package's ``batch_specs``."""
    return {k: v for k, v in batch(cfg, seed, B, S).items() if k != "labels"}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Configs, M-RoPE, parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS + ["qwen2_vl_72b", "musicgen_medium"])
def test_config_matches_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(smoke(get_config(arch))) == \
        dataclasses.asdict(jmc.smoke(jget_config(arch)))
    assert get_config(arch).param_count() == jget_config(arch).param_count()


@pytest.mark.parametrize("n_patches,n_text", [
    (0, 1), (0, 7), (1, 0), (1, 7), (10, 0), (10, 7), (64, 0), (64, 7)])
def test_mrope_positions_match_jax(n_patches, n_text):
    """The stub layout exactly: 10 patches fill a 4 x 4 grid in part."""
    want = np.asarray(jlayers.mrope_positions(3, n_patches, n_text))
    got = layers.mrope_positions(3, n_patches, n_text)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == want.shape == (3, 3, n_patches + n_text)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, hd):
    """Smoke and published sections; positions of a prompt with a 6 x 6
    patch grid, then a decode step's equal streams, then random ones."""
    rng = np.random.RandomState(hd)
    x = rng.randn(2, 40, 3, hd).astype(np.float32)
    grids = [np.array(jlayers.mrope_positions(2, 36, 4)),
             np.full((3, 2, 40), 57, np.int32),
             rng.randint(0, 5000, (3, 2, 40)).astype(np.int32)]
    for pos in grids:
        want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                   1_000_000.0, sections)
        got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                                 1_000_000.0, sections)
        close(got, want, **ROPE_TOL)
    # Equal streams are plain RoPE.
    torch.testing.assert_close(
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(grids[1]),
                           10_000.0, sections),
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(grids[1][0]),
                          10_000.0))


def test_mrope_sections_must_cover_half_the_head_dim():
    pos = layers.mrope_positions(1, 4, 4)
    with pytest.raises(AssertionError):
        layers.mrope_cos_sin(pos, 16, 10_000.0, (2, 3, 2))


@pytest.mark.parametrize("n_patch,n_text", [(6, 18), (0, 1), (0, 5)])
def test_positions_match_jax(n_patch, n_text):
    """``LM.positions`` against ``lm._positions``: the tokens are the text
    and the rest are patches, including none."""
    jcfg, _, cfg, model = build("qwen2-vl-72b")
    b = {"tokens": np.zeros((2, n_text), np.int32)}
    S = n_patch + n_text
    want = np.asarray(jlm._positions(jcfg, to_jax(b), 2, S))
    got = model.positions(to_torch(b), 2, S)
    np.testing.assert_array_equal(got.numpy(), want)


def test_convert_covers_every_parameter_and_round_trips(built):
    """``frontend_proj`` is a top-level leaf of both modes; qwen2-vl's head
    is untied (``unembed``), musicgen's tied to its embedding."""
    arch, _, jparams, cfg, model = built
    flat = _flatten(jparams)
    assert "frontend_proj" in flat
    assert ("unembed" in flat) == (arch == "qwen2-vl-72b")
    assert model.frontend_proj.shape == (cfg.d_model, cfg.d_model)
    back = convert.numpy_from_params(model)
    assert list(back) == list(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    with pytest.raises(KeyError, match="exactly once"):
        convert.params_from_numpy(cfg, {k: v for k, v in flat.items()
                                        if k != "frontend_proj"},
                                  device="cpu")


def test_token_models_have_no_frontend():
    _, jparams, _, model = build("llama3.2-1b")
    assert "frontend_proj" not in _flatten(jparams)
    assert not hasattr(model, "frontend_proj")


# ---------------------------------------------------------------------------
# The model against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_runs(built):
    """The JAX package's forward, and its prefill plus decode steps, once
    for both of the port's paths."""
    _, jcfg, jparams, cfg, _ = built
    fwd_in = batch(cfg, 0, 2, PROMPT_LEN)           # masked labels in row 1
    fwd = jlm.forward(jcfg, jparams, to_jax(fwd_in))
    pre_in = prompt(cfg, 2, 2, PROMPT_LEN)
    jlogits, jcache, jpos = jlm.prefill(jcfg, jparams, to_jax(pre_in),
                                        MAX_LEN)
    follow = [prompt(cfg, 10 + t, 2, 1) for t in range(DECODE_STEPS)]
    steps = [(jlogits, _flatten(jcache))]
    for t, b in enumerate(follow):
        jlogits, jcache = jlm.decode_step(jcfg, jparams, to_jax(b), jcache,
                                          jnp.int32(PROMPT_LEN + t))
        steps.append((jlogits, _flatten(jcache)))
    return fwd_in, fwd, pre_in, jpos, follow, steps


@pytest.mark.parametrize("plain", [False, True], ids=["ops", "plain"])
def test_forward_matches_jax(plain, built, jax_runs):
    _, _, _, cfg, model = built
    fwd_in, (jloss, jlogits) = jax_runs[:2]
    loss, logits = model(to_torch(fwd_in), plain=plain)
    assert logits.shape == (2, PROMPT_LEN, cfg.padded_vocab)
    close(logits, jlogits)
    close(loss, jloss)


@pytest.mark.parametrize("plain", [False, True], ids=["ops", "plain"])
def test_prefill_and_decode_match_jax(plain, built, jax_runs):
    """A prompt of 24 positions and 4 decode steps, each with the mode's
    keys (a mixed step carries a (B, 0, d) ``patch_embeds``): logits after
    each, and every cache leaf after the prefill and after the last step."""
    _, _, _, cfg, model = built
    _, _, pre_in, jpos, follow, steps = jax_runs

    def same_cache(cache, jflat):
        flat = flat_cache(cache)
        assert sorted(flat) == sorted(jflat)
        for key, t in flat.items():
            close(t, jflat[key])

    model.plain_kernels = plain
    try:
        logits, cache, pos = model.prefill(to_torch(pre_in), MAX_LEN)
        assert pos == jpos == PROMPT_LEN
        close(logits, steps[0][0])
        same_cache(cache, steps[0][1])
        for t, b in enumerate(follow):
            if cfg.input_mode == "mixed":
                assert b["patch_embeds"].shape == (2, 0, cfg.d_model)
            logits, cache = model.decode_step(to_torch(b), cache,
                                              PROMPT_LEN + t)
            close(logits, steps[t + 1][0])
        same_cache(cache, steps[-1][1])
    finally:
        model.plain_kernels = False


def test_a_prompt_of_one_token_has_no_patches():
    """A mixed prompt of one token: ``patch_embeds`` is (B, 0, d), the grid
    is 1 x 1 and the text sits at position 0 on every stream."""
    jcfg, jparams, cfg, model = build("qwen2-vl-72b")
    b = prompt(cfg, 5, 2, 1)
    assert b["patch_embeds"].shape == (2, 0, cfg.d_model)
    jlogits, jcache, _ = jlm.prefill(jcfg, jparams, to_jax(b), 8)
    logits, cache, pos = model.prefill(to_torch(b), 8)
    assert pos == 1
    close(logits, jlogits)
    jflat = _flatten(jcache)
    for key, t in flat_cache(cache).items():
        close(t, jflat[key])


def test_mrope_changes_the_logits():
    """The patches' grid positions differ per stream, so the same weights
    under plain RoPE give other logits: the parity above holds M-RoPE."""
    _, jparams, cfg, model = build("qwen2-vl-72b")
    other = convert.params_from_numpy(dataclasses.replace(cfg, mrope=False),
                                      _flatten(jparams), device="cpu")
    b = to_torch(prompt(cfg, 0, 2, PROMPT_LEN))
    with torch.no_grad():
        want, _, _ = model.prefill(b, MAX_LEN)
        got, _, _ = other.prefill(b, MAX_LEN)
    assert float((got - want).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_embeddings_are_cast_before_the_projection(arch):
    """A bf16 model takes fp32 embeddings, casts them to bf16 and projects
    them in bf16, as the JAX package does."""
    jcfg = jmc.smoke(jget_config(arch))
    cfg = smoke(get_config(arch))
    jparams = jlm.init_model(jcfg, jax.random.key(0), jnp.bfloat16)
    model = convert.params_from_numpy(cfg, _flatten(jparams),
                                      dtype=torch.bfloat16, device="cpu")
    b = prompt(cfg, 3, 2, PROMPT_LEN)
    want = jlm.embed_inputs(jcfg, jparams, to_jax(b))
    with torch.no_grad():
        got = model.embed_inputs(to_torch(b))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close(got, want, rtol=3e-2, atol=3e-2)


# ---------------------------------------------------------------------------
# Training and checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One fp32 AdamW step from the same weights and batch (the mode's
    keys), at step 0 (lr 0) and step 1: loss, every gradient leaf,
    ``frontend_proj``'s included, the parameters and both moments within
    2e-5 of each leaf's largest value."""
    jcfg, cfg = jmc.smoke(jget_config(arch)), smoke(get_config(arch))
    report = step_errors(arch, jcfg, cfg,
                         jlm.init_model(jcfg, jax.random.key(0)))
    assert max(report.values()) <= 2e-5, report


@pytest.mark.parametrize("arch", ARCHS)
def test_epochs_restore_across_the_packages(arch, tmp_path):
    """A Cornus epoch of the smoke state (parameters with ``frontend_proj``
    and, for qwen2-vl, ``unembed``; both moments) committed by either
    package restores in the other, leaf for leaf."""
    jstate = jax_state(arch)
    commit(True, jstorage.FileStore(str(tmp_path / "jax")), jstate, 7)
    store = FileStore(str(tmp_path / "jax"))
    assert ckpt.latest_committed(store, HOSTS) == 7
    state = port_state(arch)
    ckpt.restore_params(store, HOSTS, 7, state)
    got, want = shards._flatten(state), jckpt.shards._flatten(jstate)
    assert list(got) == list(want)
    leaves = {"params/frontend_proj", "opt/m/frontend_proj"}
    if arch == "qwen2-vl-72b":
        leaves |= {"params/unembed", "opt/v/unembed"}
    assert leaves <= set(want)
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
    assert leaves <= set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_takes_token_prompts_only(arch):
    """``launch.serve.generate`` serves token prompts, as the JAX package's
    does; a stub-mode model is refused with a pointer to ``LM.prefill``."""
    from repro_torch.launch import serve
    cfg = smoke(get_config(arch))
    model = convert.params_from_numpy(cfg, _flatten(jlm.init_model(
        jmc.smoke(jget_config(arch)), jax.random.key(0))), device="cpu")
    with pytest.raises(ValueError, match="LM.prefill"):
        serve.generate(cfg, model, np.zeros((2, 4), np.int32),
                       serve.ServeConfig(max_new_tokens=2, max_len=8),
                       device="cpu")
    with pytest.raises(ValueError, match="token prompts"):
        serve.main(["--arch", arch, "--device", "cpu", "--requests", "1"])
