"""Each layer of the plain reference against the port's plain path, in
fp32 at a small size on the CPU, on the same drawn weights; then whole
models, the port's prefill and decode steps through its cache against the
reference's one pass over the sequence."""
import numpy as np
import pytest
import torch

from perfbench import check, registry, weights
from perfbench.reference import decoder
from perfbench.reference.precision import Precision
from perfbench.tests import tiny

SEED = 2 ** 31 + 7


def close(got, want, tol=2e-5):
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol * scale


def built(cell):
    from repro_torch.models.lm import LM
    cfg = tiny.config(cell)
    plan = registry.module("models", cfg["model_type"]).plan(cfg)
    plan.dtype = torch.float32
    mc = registry.module("adapters", cfg["model_type"]).port_config(cfg)
    model = LM(mc, dtype=torch.float32, device="cpu")
    model.requires_grad_(False)
    weights.fill(dict(model.named_parameters()), decoder.schema(plan), SEED)
    return mc, plan, model


def layer_weights(plan, prefix):
    names = [n for n in decoder.schema(plan) if n.startswith(prefix)]
    return decoder._weights(names, plan, SEED, "cpu", strip=prefix)


# (cell, layer, part, reference kind)
LAYERS = [("jamba-prefill", 4, "mixer", "attention"),
          ("jamba-prefill", 0, "mixer", "mamba"),
          ("jamba-prefill", 0, "ffn", "ffn"),
          ("jamba-prefill", 1, "ffn", "moe"),
          ("minicpm-decode", 1, "mixer", "attention"),
          ("minicpm-decode", 1, "ffn", "ffn")]


@pytest.mark.parametrize("cell,li,part,kind", LAYERS,
                         ids=[f"{c}-{k}" for c, _, _, k in LAYERS])
def test_layer_matches_the_port(cell, li, part, kind):
    from repro_torch.models import blocks, lm
    from repro_torch.models.layers import text_positions
    mc, plan, model = built(cell)
    B, S = 3, 20
    x = torch.randn(B, S, mc.d_model, generator=torch.Generator().manual_seed(1))
    params = model.layers[li][part]
    with torch.no_grad():
        if part == "mixer":
            ropes = lm.rope_tables(mc, text_positions(B, S))
            ctx = lm.layer_ctx(mc, mc.full_pattern[li], ropes, mode="train",
                               plain=True)
            want, _ = blocks.mixer(mc.full_pattern[li])[1](mc, params, x, ctx)
        else:
            want, _ = blocks.ffn_apply(mc, params, x, lm.layer_is_moe(mc, li))
    w = layer_weights(plan, f"layers.{li}.{part}.")
    got = registry.module("reference", kind).apply(
        w, x, decoder.Ctx(Precision(), plan.dims, prefix=S))
    close(got, want)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_served_logits_match_the_port(cell):
    """Prefill then decode steps through the port's cache (the MoE routed
    per step) against one reference pass: embedding, every layer, head."""
    _, plan, model = built(cell)
    B, S, n = 3, 30, 5
    vocab = plan.dims["vocab"]
    prompts = np.random.default_rng(3).integers(0, vocab, (B, S))
    outs = []
    with torch.inference_mode():
        logits, cache, _ = model.prefill({"tokens": torch.from_numpy(prompts)},
                                         S + n)
        outs.append(logits[:, -1, :vocab])
        toks = [outs[-1].argmax(-1)]
        for i in range(1, n):
            logits, cache = model.decode_step({"tokens": toks[-1][:, None]},
                                              cache, S + i - 1)
            outs.append(logits[:, -1, :vocab])
            toks.append(outs[-1].argmax(-1))
    served = torch.stack(toks).numpy()
    ref = check.reference_logits(plan, SEED, prompts, served, "cpu")
    close(torch.stack(outs, 1), ref)


def test_weights_redraw_alike():
    p = weights.Param((3, 4), std=0.5, mean=1.0)
    a = weights.draw(p, 5, "layers.0.x", torch.bfloat16, "cpu")
    assert torch.equal(a, weights.draw(p, 5, "layers.0.x", torch.bfloat16,
                                       "cpu"))
    assert not torch.equal(a, weights.draw(p, 5, "layers.1.x",
                                           torch.bfloat16, "cpu"))
    big = weights.draw(p, 2 ** 31 + 99, "x", torch.float32, "cpu")
    assert big.shape == (3, 4)
