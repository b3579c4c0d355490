"""Per-architecture smoke tests of the port: the torch twin of
tests/test_arch_smoke.py, on the CPU, with no JAX.

Each architecture the port carries (``repro_torch.configs.ARCH_IDS``, all
ten of the JAX package's) builds its REDUCED same-family config and runs,
with the batch keys of its input mode:
  * one forward pass (loss finite, logits shaped (B, S, padded_vocab));
  * one SGD step (loss and gradient norm finite, parameters move);
  * a prefill and one decode step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import init_model, smoke  # noqa: E402


def make_batch(cfg, B=2, S=32, seed=0):
    """The reference test's batch: tokens; frame embeddings; or a quarter
    of patch embeddings (at least one) before tokens.  Labels span S."""
    rng = np.random.RandomState(seed)
    batch = {}
    if cfg.input_mode == "tokens":
        toks = rng.randint(0, cfg.vocab_size, (B, S))
        batch["tokens"] = toks
        batch["labels"] = toks
    elif cfg.input_mode == "embeds":
        batch["frame_embeds"] = rng.randn(B, S, cfg.d_model)
        batch["labels"] = rng.randint(0, cfg.vocab_size, (B, S))
    else:
        n_patch = max(1, int(S * cfg.patch_frac))
        batch["patch_embeds"] = rng.randn(B, n_patch, cfg.d_model)
        batch["tokens"] = rng.randint(0, cfg.vocab_size, (B, S - n_patch))
        batch["labels"] = rng.randint(0, cfg.vocab_size, (B, S))
    return {k: torch.from_numpy(v.astype(np.float32 if v.dtype.kind == "f"
                                         else np.int64))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = smoke(get_config(arch))
            cache[arch] = (cfg, init_model(cfg, 0, device="cpu"))
        return cache[arch]

    return get


def test_the_port_carries_every_arch():
    assert len(ARCH_IDS) == 10 and "kimi_k2_1t_a32b" in ARCH_IDS
    assert {get_config(a).input_mode for a in ARCH_IDS} == \
        {"tokens", "embeds", "mixed"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_shapes_and_finiteness(arch, built):
    cfg, model = built(arch)
    with torch.no_grad():
        loss, logits = model(make_batch(cfg))
    assert logits.shape == (2, 32, cfg.padded_vocab)
    assert torch.isfinite(loss), f"{arch}: loss {loss}"
    assert not torch.isnan(logits).any(), f"{arch}: NaN logits"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_updates_params(arch, built):
    """One SGD step on the plain path's gradients, on a copy of the
    parameters (the module's model stays as built)."""
    cfg, model = built(arch)
    loss, grads = steps.loss_and_grads(model, make_batch(cfg))
    gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    assert torch.isfinite(loss) and torch.isfinite(gnorm) and gnorm > 0, \
        f"{arch}: loss={loss} gnorm={gnorm}"
    params = dict(model.named_parameters())
    new = {n: p.detach() - 1e-3 * grads[n] for n, p in params.items()}
    assert any(not torch.allclose(new[n], p) for n, p in params.items()), \
        f"{arch}: no parameter changed"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_then_decode(arch, built):
    cfg, model = built(arch)
    B, S, max_len = 2, 16, 24
    batch = make_batch(cfg, B=B, S=S)
    batch.pop("labels")
    logits, cache, pos = model.prefill(batch, max_len)
    assert pos == S and logits.shape == (B, 1, cfg.padded_vocab)
    assert not torch.isnan(logits).any()

    tok = logits[:, -1, :cfg.vocab_size].argmax(-1)
    if cfg.input_mode == "tokens":
        step_in = {"tokens": tok[:, None]}
    elif cfg.input_mode == "embeds":
        step_in = {"frame_embeds": torch.zeros((B, 1, cfg.d_model))}
    else:
        step_in = {"tokens": tok[:, None],
                   "patch_embeds": torch.zeros((B, 0, cfg.d_model))}
    logits2, _ = model.decode_step(step_in, cache, S)
    assert logits2.shape == (B, 1, cfg.padded_vocab)
    assert not torch.isnan(logits2).any(), f"{arch}: NaN decode logits"
