"""The kernels have no backward, so their wrappers refuse an input that
requires grad while grad is enabled (ValueError), before any device check,
and accept it under ``torch.no_grad()`` and ``torch.inference_mode()``;
and the model's training forward reaches every parameter."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import (decode_attention, flash_attention,  # noqa: E402
                                 mamba_scan, mlstm_scan)
from repro_torch.models import init_model, smoke  # noqa: E402


def inputs(name, grad):
    """CPU inputs of one wrapper at a small legal shape; the first one
    requires grad when ``grad``."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    if name == "flash_attention":
        args = [r(1, 2, 16, 32), r(1, 2, 16, 32), r(1, 2, 16, 32)]
        call = flash_attention.flash_attention
    elif name == "flash_decode":
        args = [r(1, 2, 1, 32), r(1, 2, 16, 32), r(1, 2, 16, 32), 8]
        call = decode_attention.flash_decode
    elif name == "mlstm_scan":
        args = [r(1, 8, 2, 16), r(1, 8, 2, 16), r(1, 8, 2, 16),
                torch.rand(1, 8, 2), torch.rand(1, 8, 2),
                torch.zeros(1, 2, 16, 16)]
        call = mlstm_scan.mlstm_scan
    else:
        args = [r(1, 8, 64), torch.rand(1, 8, 64), -torch.rand(64, 8),
                r(1, 8, 8), r(1, 8, 8), torch.zeros(1, 64, 8)]
        call = mamba_scan.mamba_scan
    args[0].requires_grad_(grad)
    return call, args


KERNELS = ["flash_attention", "flash_decode", "mlstm_scan", "mamba_scan"]


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_refuses_an_input_that_requires_grad(name):
    call, args = inputs(name, grad=True)
    with pytest.raises(ValueError, match="has no backward"):
        call(*args)


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_wrapper_takes_it_without_grad(name, mode):
    """Without grad the check passes, and the wrapper goes on to refuse
    the CPU tensors as before: it never computes on the CPU."""
    call, args = inputs(name, grad=True)
    with getattr(torch, mode)():
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call(*args)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "xlstm-125m",
                                  "jamba-v0.1-52b"])
def test_training_forward_reaches_every_parameter(arch):
    cfg = smoke(get_config(arch))
    model = init_model(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 16)))
    loss, _ = model({"tokens": toks, "labels": toks})   # ops: plain on CPU
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert torch.isfinite(loss)
    dead = [n for n, g in grads.items() if not float(g.abs().max()) > 0]
    assert not dead, f"{arch}: parameters without a gradient: {dead}"


def test_serving_records_no_graph():
    cfg = smoke(get_config("llama3.2-1b"))
    model = init_model(cfg, 0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    logits, cache, _ = model.prefill({"tokens": toks}, 8)
    assert not logits.requires_grad and torch.is_inference(logits)
    logits, _ = model.decode_step({"tokens": toks[:, :1]}, cache, 4)
    assert not logits.requires_grad
    assert all(p.requires_grad for p in model.parameters())
