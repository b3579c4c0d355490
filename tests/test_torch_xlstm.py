"""The port's xlstm-125m (smoke size) against the JAX package, on the CPU.

As in tests/test_torch_model.py, the JAX parameters are flattened to numpy
leaves and carried into the port by ``repro_torch.convert``; both packages
then see the same tokens.  Model tolerances are fp32 1e-4; the recurrent
states are compared leaf by leaf.  The first tests pin three repairs of the
port that only a recurrent model exposes.
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
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (blocks, init_cache, layer_cache, lm,  # noqa: E402
                                smoke)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "xlstm-125m"


def build():
    jcfg = jmc.smoke(jget_config(ARCH))
    cfg = smoke(get_config(ARCH))
    jparams = jlm.init_model(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(cfg, _flatten(jparams), device="cpu")
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def xlstm():
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
# Repairs of the port
# ---------------------------------------------------------------------------
def test_init_cache_keeps_recurrent_states_in_fp32():
    """``PSpec.dtype`` pins the mLSTM/sLSTM states to fp32 whatever the
    activations' dtype, as ``s.dtype or dtype`` does in the JAX package."""
    cfg = smoke(get_config(ARCH))
    cache = flat_cache(init_cache(cfg, 2, 8, dtype=torch.bfloat16,
                                  device="cpu"))
    jcache = _flatten(jlm.init_cache(jmc.smoke(jget_config(ARCH)), 2, 8,
                                     dtype=jnp.bfloat16))
    assert sorted(cache) == sorted(jcache)
    for key, t in cache.items():
        assert t.dtype == torch.float32, key
        assert tuple(t.shape) == jcache[key].shape, key
        assert jcache[key].dtype == np.float32, key
    # The attention cache still takes the activations' dtype.
    llama = flat_cache(init_cache(smoke(get_config("llama3.2-1b")), 1, 8,
                                  dtype=torch.bfloat16, device="cpu"))
    assert {t.dtype for t in llama.values()} == {torch.bfloat16}


def test_layer_specs_add_an_ffn_only_to_attention_and_mamba_kinds():
    cfg = dataclasses.replace(smoke(get_config(ARCH)), d_ff=128)
    jcfg = dataclasses.replace(jmc.smoke(jget_config(ARCH)), d_ff=128)
    for li in range(cfg.n_layers):
        assert "ffn" not in blocks.layer_specs(cfg, li)
        assert sorted(blocks.layer_specs(cfg, li)) == \
            sorted(jblocks.layer_specs(jcfg, li))
    llama = smoke(get_config("llama3.2-1b"))
    assert "ffn" in blocks.layer_specs(llama, 0)


def test_rope_tables_are_built_only_with_attention(monkeypatch, xlstm):
    _, _, _, model = xlstm
    calls = []
    real = lm.rope_cos_sin
    monkeypatch.setattr(lm, "rope_cos_sin",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    toks = torch.from_numpy(tokens(9, 1, 6))
    model({"tokens": toks, "labels": toks})
    _, cache, _ = model.prefill({"tokens": toks}, 8)
    model.decode_step({"tokens": toks[:, :1]}, cache, 6)
    assert calls == []


# ---------------------------------------------------------------------------
# Config, conversion, cells
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [ARCH, "xlstm_125m"])
def test_config_matches_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(smoke(get_config(arch))) == \
        dataclasses.asdict(jmc.smoke(jget_config(arch)))
    # The copied count, quirk included (ROADMAP Queue 3): the mLSTM term
    # counts 3·di²/4 of the 3·di² that mlstm_specs holds.
    assert get_config(arch).param_count() == \
        jget_config(arch).param_count() == 101_315_328


def test_convert_covers_every_parameter(xlstm):
    jcfg, jparams, cfg, model = xlstm
    flat = _flatten(jparams)
    assert len(list(model.parameters())) == \
        sum(a.shape[0] if k.startswith("layers/") else 1
            for k, a in flat.items())
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in flat.values())
    period = len(cfg.pattern)
    np.testing.assert_array_equal(
        model.layers[period + 5].mixer.r_gates.detach().numpy(),
        flat["layers/p5/mixer/r_gates"][1])
    with pytest.raises(KeyError):
        convert.params_from_numpy(cfg, {k: v for k, v in flat.items()
                                        if k != "layers/p2/mixer/w_if"},
                                  device="cpu")


def test_full_width_parameter_count():
    """xlstm-125m at full width holds 154,093,824 parameters (the JAX specs'
    count); no tensor is allocated."""
    cfg = get_config(ARCH)
    specs = lm.model_specs(cfg)
    leaves = [s for layer in specs["layers"] for part in layer.values()
              for s in part.values()]
    leaves += [s for k, s in specs.items() if k != "layers"]
    assert sum(math.prod(s.shape) for s in leaves) == 154_093_824
    assert specs["layers"][5]["mixer"]["r_gates"].shape == (4, 192, 768)


@pytest.mark.parametrize("S,chunk", [(12, 256), (20, 8)],
                         ids=["one_chunk", "ragged_chunks"])
def test_mlstm_cell_matches_jax(S, chunk, monkeypatch):
    """The plain chunkwise cell, its ragged tail padded as the JAX cell pads
    it (f included, which wipes the state: ROADMAP Queue 3).  The
    normalizer that ``ops.mlstm`` returns with ``n0`` (the kernel's
    contract) is the exact recurrence's, as ``ref.mlstm_ref`` carries it."""
    monkeypatch.setattr(blocks, "MLSTM_CHUNK", chunk)
    monkeypatch.setattr(jblocks, "MLSTM_CHUNK", chunk)
    B, H, hd = 2, 2, 16
    jq, q = randn(0, (B, S, H, hd))
    jk, k = randn(1, (B, S, H, hd), 0.25)
    jv, v = randn(2, (B, S, H, hd))
    ji, i = (jax.nn.sigmoid(randn(3, (B, S, H))[0]),
             torch.sigmoid(randn(3, (B, S, H))[1]))
    jf, f = (jax.nn.sigmoid(randn(4, (B, S, H))[0] + 2.0),
             torch.sigmoid(randn(4, (B, S, H))[1] + 2.0))
    jc0, c0 = randn(5, (B, H, hd, hd), 0.3)
    jn0, n0 = randn(6, (B, H, hd), 0.3)
    y, c_last, n_last = blocks._mlstm_cell(q, k, v, i, f, c0, n0)
    jy, jc, jn = jblocks._mlstm_cell(jq, jk, jv, ji, jf, jc0, jn0)
    close(y, jy, rtol=1e-5, atol=1e-5)
    close(c_last, jc, rtol=1e-5, atol=1e-5)
    close(n_last, jn, rtol=1e-5, atol=1e-5)
    _, jc_seq, jn_seq = jref.mlstm_ref(jq, jk, jv, ji, jf, jc0, jn0)
    _, _, n_ops = ops.mlstm(q, k, v, i, f, c0, n0=n0)
    close(n_ops, jn_seq, rtol=1e-5, atol=1e-5)
    if S % chunk and S > chunk:
        assert float(jnp.abs(jc).max()) < 1e-20 < float(jnp.abs(jc_seq).max())


def test_ragged_prompt_above_the_chunk_wipes_the_state_on_both_paths(xlstm):
    """A 300-token prefill (above the 256-row chunk, not a multiple of it)
    through ``mlstm_apply``: the JAX cell pads the tail with f = 0, which
    wipes C and n.  The plain path pads the same way; the kernel path (here
    the sequential recurrence behind ``ops.mlstm``) pads with f = 1 and
    then applies the padded rows' decay itself, so both paths give the JAX
    model's wiped state.  The outputs agree with the JAX model's and with
    one unpadded chunk's (ROADMAP Queue 3)."""
    jcfg, jparams, cfg, model = xlstm
    B, S = 1, 300
    jx, x = randn(20, (B, S, cfg.d_model))
    p = model.layers[0].mixer
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["layers"]["p0"]["mixer"])

    def run(plain, chunk=blocks.MLSTM_CHUNK):
        cache = layer_cache(cfg, init_cache(cfg, B, S, device="cpu"), 0)
        old, blocks.MLSTM_CHUNK = blocks.MLSTM_CHUNK, chunk
        try:
            out, _ = blocks.mlstm_apply(cfg, p, x, blocks.Ctx(
                mode="prefill", cache=cache, plain=plain))
        finally:
            blocks.MLSTM_CHUNK = old
        return out, cache

    plain_out, plain_cache = run(True)
    kernel_out, kernel_cache = run(False)
    exact_out, exact_cache = run(True, chunk=512)     # one chunk, no padding
    jout, jcache = jblocks.mlstm_apply(jcfg, jp, jx, jblocks.Ctx(
        mode="prefill", positions=None, theta=0.0, cache=None))
    close(plain_out, jout)
    close(kernel_out, jout)
    torch.testing.assert_close(kernel_out, exact_out, **TOL)
    for name in ("C", "n"):
        close(plain_cache[name], jcache[name])
        close(kernel_cache[name], jcache[name])
        torch.testing.assert_close(kernel_cache[name], plain_cache[name],
                                   **TOL)
        assert float(plain_cache[name].abs().max()) < 1e-20
        assert float(kernel_cache[name].abs().max()) < 1e-20
        assert float(exact_cache[name].abs().max()) > 1e-3


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_slstm_apply_matches_jax(mode, xlstm):
    jcfg, jparams, cfg, model = xlstm
    B, S = 2, 5 if mode != "decode" else 1
    jx, x = randn(7, (B, S, cfg.d_model))
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["layers"]["p5"]["mixer"])
    p = model.layers[5].mixer
    jcache = cache = None
    if mode != "train":
        states = [randn(10 + n, (B, cfg.d_model), 0.5) for n in range(4)]
        jcache = dict(zip("cnhm", (s[0] for s in states)))
        cache = dict(zip("cnhm", (s[1].clone() for s in states)))
    jctx = jblocks.Ctx(mode=mode, positions=None, theta=0.0, cache=jcache)
    ctx = blocks.Ctx(mode=mode, cache=cache)
    jout, jnew = jblocks.slstm_apply(jcfg, jp, jx, jctx)
    out, new = blocks.slstm_apply(cfg, p, x, ctx)
    close(out, jout)
    if mode != "train":
        assert new is cache                      # written in place
        for n in "cnhm":
            assert cache[n].dtype == torch.float32
            close(cache[n], jnew[n])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
def test_forward_matches_jax(xlstm):
    jcfg, jparams, cfg, model = xlstm
    toks = tokens(0, 2, 16)
    toks_lb = toks.copy()
    toks_lb[1, :4] = -1                                  # masked labels
    jloss, jlogits = jlm.forward(jcfg, jparams,
                                 {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(toks_lb)})
    loss, logits = model({"tokens": torch.from_numpy(toks),
                          "labels": torch.from_numpy(toks_lb)})
    assert logits.shape == (2, 16, cfg.padded_vocab)
    close(logits, jlogits)
    close(loss, jloss)


def test_prefill_and_decode_match_jax(xlstm):
    jcfg, jparams, cfg, model = xlstm
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

    def same_cache():
        jflat, flat = _flatten(jcache), flat_cache(cache)
        assert sorted(flat) == sorted(jflat)
        assert len(flat) == 10 + 4               # five mLSTM C/n, sLSTM cnhm
        for key, t in flat.items():
            assert t.dtype == torch.float32, key
            close(t, jflat[key])

    same_cache()
    for t in range(steps):
        tok = follow[:, t:t + 1]
        jlogits, jcache = jlm.decode_step(jcfg, jparams,
                                          {"tokens": jnp.asarray(tok)},
                                          jcache, jnp.int32(S + t))
        logits, cache = model.decode_step({"tokens": torch.from_numpy(tok)},
                                          cache, S + t)
        close(logits, jlogits)
    same_cache()


def test_decode_matches_forward(xlstm):
    """Teacher-forced decode == train forward logits."""
    _, _, _, model = xlstm
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
    torch.testing.assert_close(full_logits[:, 3:], dec, rtol=1e-4, atol=1e-4)


def test_greedy_generate_matches_jax(xlstm):
    jcfg, jparams, cfg, model = xlstm
    prompts = tokens(6, 3, 8)
    want = jserve.generate(jcfg, jparams, jnp.asarray(prompts),
                           jserve.ServeConfig(max_new_tokens=10, max_len=32))
    got = serve.generate(cfg, model, prompts,
                         serve.ServeConfig(max_new_tokens=10, max_len=32),
                         device="cpu")
    np.testing.assert_array_equal(got, want)


def test_plain_and_kernel_paths_agree_on_cpu(xlstm):
    """With CPU tensors ``ops.mlstm`` takes the sequential ``ref.mlstm_ref``
    and the block computes n beside it; the plain path takes the chunkwise
    cell.  Logits agree at 1e-5 and every cache leaf at the model's 1e-4
    (the states of later layers see the earlier layers' rounding)."""
    _, _, _, model = xlstm
    prompt = torch.from_numpy(tokens(1, 2, 12))
    follow = torch.from_numpy(tokens(4, 2, 3))

    def run():
        logits, cache, pos = model.prefill({"tokens": prompt}, 16)
        outs = [logits]
        for t in range(follow.shape[1]):
            logits, cache = model.decode_step(
                {"tokens": follow[:, t:t + 1]}, cache, pos + t)
            outs.append(logits)
        return torch.cat(outs, dim=1), flat_cache(cache)

    via_ops, ops_cache = run()
    model.plain_kernels = True
    try:
        plain, plain_cache = run()
    finally:
        model.plain_kernels = False
    torch.testing.assert_close(via_ops, plain, rtol=1e-5, atol=1e-5)
    for key, t in ops_cache.items():
        torch.testing.assert_close(t, plain_cache[key], **TOL)


def test_probe_measures_free_running_gaps_on_cpu(capsys):
    """``launch/xlstm_probe`` at smoke size on the CPU: the chunkwise cell
    and the sequential recurrence give the same model to rounding, and
    the script prints one line per weight seed."""
    from repro_torch.launch import xlstm_probe
    res = xlstm_probe.probe(smoke(get_config(ARCH)), torch.device("cpu"),
                            batch=2, prompt=20, steps=3)
    assert [r["weight_seed"] for r in res] == list(xlstm_probe.SEEDS)
    for r in res:
        assert r["pair"] == "chunkwise vs sequential"
        assert len(r["logit_max_abs_diff_per_pass"]) == 4
        assert r["max"] < 1e-4 and r["greedy_tokens_differ"] == 0
    assert capsys.readouterr().out.count('"pair"') == len(res)


def test_serve_main_runs_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--batch", "2", "--max-new", "4"]) == 12
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out
