"""chip_smoke.py off the card: it refuses to report without a card or outside
a checkout, and its bound arithmetic counts what the calls need."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def run_script(path: Path, cwd: Path):
    return subprocess.run([sys.executable, str(path)], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = run_script(ROOT / "chip_smoke.py", ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "kernels" not in res.stdout
    assert "no CUDA device" in res.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = run_script(tmp_path / "chip_smoke.py", tmp_path)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "not a checkout" in res.stderr


def test_decode_bound_counts_the_valid_cache_only():
    ms, by, nbytes, flops = chip_smoke.attention_bound(
        4, 32, 8, 1, 512, 64, causal=False, kv_len=272)
    # q and o: 2 * 4*32*64; K and V up to kv_len: 2 * 4*8*272*64; bf16.
    assert nbytes == 2 * (2 * 4 * 32 * 64 + 2 * 4 * 8 * 272 * 64)
    assert flops == 4 * 4 * 32 * 64 * 272
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_causal_bound_counts_visible_pairs():
    _, _, _, flops = chip_smoke.attention_bound(1, 1, 1, 4, 4, 8,
                                                causal=True)
    assert flops == 4 * 8 * (1 + 2 + 3 + 4)
    _, _, _, flops = chip_smoke.attention_bound(1, 1, 1, 2, 6, 8,
                                                causal=True, q_offset=3)
    assert flops == 4 * 8 * (4 + 5)
    ms, by, _, _ = chip_smoke.attention_bound(4, 32, 8, 4096, 4096, 64,
                                              causal=True)
    assert by == "operations"


def test_mlstm_bound_counts_the_served_calls():
    """The serving shapes of xlstm-125m: the prefill is bound by the
    recurrence's operations (2.4 GFLOP, 44 MB) at the 3xTF32 rate the
    kernel computes at (495/3 TFLOP/s), a decode step by the bytes of the
    state."""
    ms, by, nbytes, flops = chip_smoke.mlstm_bound(4, 256, 4, 384)
    # 4·hd² per token and head: the update k vᵀ and the product q·C.
    assert flops == 4 * 4 * 256 * 4 * 384 * 384 == 2_415_919_104
    assert nbytes == 4 * (4 * 4 * 256 * 4 * 384 + 2 * 4 * 256 * 4) \
        + 2 * 4 * 4 * 4 * 384 * 384
    assert by == "operations"
    assert ms == pytest.approx(flops / (495e12 / 3) * 1e3)
    assert ms == pytest.approx(0.01464, abs=1e-5)
    assert nbytes / 3.35e12 * 1e3 < ms           # the bytes fit under it
    # The chunkwise form's causal half (2·c(c+1)·hd + 4·c·hd² per chunk of
    # c = 128) is more work, so it would give a looser bound.
    chunkwise = 4 * 4 * 2 * (2 * 128 * 129 * 384 + 4 * 128 * 384 * 384)
    assert flops < chunkwise
    ms, by, nbytes, _ = chip_smoke.mlstm_bound(4, 1, 4, 384)
    assert by == "bytes" and nbytes > 2 * 4 * 4 * 4 * 384 * 384
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_mamba_bound_counts_the_served_calls():
    """Jamba's mixer as served, fp32: u, dt and y are 33.5 MB each at the
    prefill shape, the state 2.1 MB read and 2.1 MB written.  The prefill
    is bound by its 134 M exps on the special-function units (16 a clock
    per SM), just above its bytes; a decode step by its bytes."""
    ms, by, nbytes, flops = chip_smoke.mamba_bound(4, 256, 8192, 16)
    assert nbytes == 4 * (3 * 4 * 256 * 8192 + 2 * 4 * 256 * 16) \
        + 4 * 8192 * 16 + 2 * 4 * 4 * 8192 * 16 == 105_512_960
    assert flops == 8 * 4 * 256 * 8192 * 16
    exps = 4 * 256 * 8192 * 16
    assert by == "special-function"
    assert ms == pytest.approx(exps / (132 * 16 * 1.98e9) * 1e3)
    assert ms == pytest.approx(0.0321, abs=1e-4)
    t_bytes = nbytes / 3.35e12 * 1e3
    assert t_bytes == pytest.approx(0.0315, abs=1e-4) and t_bytes < ms
    assert flops / 67e12 * 1e3 < ms              # the fp32 flops fit
    ms, by, _, _ = chip_smoke.mamba_bound(4, 256, 8192, 16, "bfloat16")
    assert by == "special-function"              # twice the byte bound
    ms, by, nbytes, _ = chip_smoke.mamba_bound(4, 1, 8192, 16)
    assert nbytes == 4 * (3 * 4 * 8192 + 2 * 4 * 16) + 4 * 8192 * 16 \
        + 2 * 4 * 4 * 8192 * 16 == 5_112_320
    assert by == "bytes" and ms == pytest.approx(0.00153, abs=1e-5)


def hold_smoke_xlstm(monkeypatch, dtype, tol):
    """``layer_parity`` on the smoke-size xLSTM on the CPU (where ``ops``
    takes the plain sequential recurrence) passes, and fails when the
    kernel path's state update is wrong."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_model, smoke

    model = init_model(smoke(get_config("xlstm-125m")), 0, dtype=dtype,
                       device="cpu")
    prompts = torch.randint(0, 512, (2, 12),
                            generator=torch.Generator().manual_seed(0))
    worst = chip_smoke.layer_parity("xlstm smoke", model, prompts, tol=tol)
    assert 0.0 <= worst["mixer_rel"] <= tol
    assert worst["cache"] <= chip_smoke.MODEL_TOL

    real = ops.mlstm

    def leaky(q, k, v, i, f, c0, **kw):
        return real(q, k, v, i, f * 0.99, c0, **kw)

    monkeypatch.setattr(ops, "mlstm", leaky)
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.layer_parity("xlstm smoke", model, prompts, tol=tol)


def test_layer_parity_runs_and_catches_a_wrong_state(monkeypatch):
    hold_smoke_xlstm(monkeypatch, torch.float32, chip_smoke.MODEL_TOL)


def test_layer_parity_holds_the_bf16_model(monkeypatch):
    """The bf16 model, as served, at the bf16 kernel tolerance."""
    hold_smoke_xlstm(monkeypatch, torch.bfloat16, chip_smoke.TOL["bfloat16"])


def hold_smoke_jamba(monkeypatch, dtype, tol):
    """``layer_parity`` on the smoke-size Jamba (mamba, attention with
    rope, dense FFN and MoE layers) on the CPU passes, the expert choices
    of both paths agree, and a wrong selective scan on the kernel path
    fails it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_model, smoke

    model = init_model(smoke(get_config("jamba-v0.1-52b")), 0, dtype=dtype,
                       device="cpu")
    prompts = torch.randint(0, 512, (2, 12),
                            generator=torch.Generator().manual_seed(0))
    worst = chip_smoke.layer_parity("jamba smoke", model, prompts, tol=tol)
    assert 0.0 <= worst["mixer_rel"] <= tol
    assert worst["cache"] <= chip_smoke.TOL["bfloat16"]
    with chip_smoke.recorded_routes(model) as routes:
        for plain in (False, True):
            model.plain_kernels = plain
            model.prefill({"tokens": prompts}, 16)
        model.plain_kernels = False
    n, total = routes.differ()
    assert total == 8 * 2 * 12                   # 8 MoE layers, 24 tokens
    # fp32 rounding moves no choice here; bf16 rounding of the mamba
    # outputs moves a few between the free-running paths.
    assert n == 0 if dtype == torch.float32 else n < total // 10

    real = ops.selective_scan

    def leaky(u, dt, a, b, c, h0, **kw):
        return real(u, dt, a * 1.05, b, c, h0, **kw)

    monkeypatch.setattr(ops, "selective_scan", leaky)
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.layer_parity("jamba smoke", model, prompts, tol=tol)


def test_layer_parity_holds_jamba(monkeypatch):
    hold_smoke_jamba(monkeypatch, torch.float32, chip_smoke.MODEL_TOL)


def test_layer_parity_holds_the_bf16_jamba(monkeypatch):
    hold_smoke_jamba(monkeypatch, torch.bfloat16, chip_smoke.TOL["bfloat16"])


# ---------------------------------------------------------------------------
# The training phase's helpers (phase 11)
# ---------------------------------------------------------------------------
def test_train_flops_and_memory_at_full_width():
    """llama3.2-1b at full width, batch 1 x 4,096 tokens, remat "full":
    about 47 TFLOP a step (30.4 + 6.6 + 10.2), 0.70 s at 67 TFLOP/s fp32;
    19.8 GB of parameters, gradients and moments, 2.1 GB of one layer's
    fp32 scores and 2.1 GB of fp32 logits."""
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b")
    assert chip_smoke.spec_elements(cfg) == 1_235_814_400
    assert chip_smoke.spec_elements(cfg) != cfg.param_count() \
        == 1_235_847_168
    f = chip_smoke.train_flops(cfg, 1, 4096)
    assert f["params"] == 6 * 1_235_814_400 * 4096
    assert f["attention"] == 3 * 4 * 32 * 64 * 4096 ** 2 * 16
    assert f["recompute"] == 2 * (1_235_814_400 - 128_256 * 2048 - 2048) \
        * 4096 + 4 * 32 * 64 * 4096 ** 2 * 16
    assert (f["params"] / 1e12, f["attention"] / 1e12,
            f["recompute"] / 1e12) == pytest.approx((30.37, 6.60, 10.17),
                                                    abs=0.01)
    assert f["total"] / 67e12 == pytest.approx(0.7036, abs=1e-3)
    assert chip_smoke.train_flops(cfg, 1, 4096, remat="none")["recompute"] \
        == 0
    m = chip_smoke.train_memory_gb(cfg, 1, 4096)
    assert m["state_gb"] == pytest.approx(19.77, abs=0.01)
    assert m["scores_gb"] == pytest.approx(2.147, abs=1e-3)
    assert m["logits_gb"] == pytest.approx(2.101, abs=1e-3)
    assert 30 <= m["estimate_gb"] <= 35


def test_directional_check_holds_the_gradient_and_catches_a_wrong_one():
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import init_model, smoke
    cfg = smoke(get_config("llama3.2-1b"))
    model = init_model(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, 64)))
    batch = {"tokens": toks, "labels": toks}
    _, grads = steps.loss_and_grads(model, batch)
    params = list(model.parameters())
    before = [p.detach().clone() for p in params]
    g = [grads[n] for n, _ in model.named_parameters()]

    def loss_at():
        with torch.no_grad():
            return model.forward(batch, plain=True)[0]

    ok = chip_smoke.directional_check(loss_at, params, g, seed=1)
    assert ok["rel"] <= 1e-2, ok
    assert all(torch.equal(p, b) for p, b in zip(params, before))
    wrong = chip_smoke.directional_check(loss_at, params,
                                         [x * 1.05 for x in g], seed=1)
    assert wrong["rel"] > 1e-2 and wrong["fd"] == ok["fd"]
    dropped = chip_smoke.directional_check(
        loss_at, params, [torch.zeros_like(x) if i % 2 else x
                          for i, x in enumerate(g)], seed=1)
    assert dropped["rel"] > 1e-2, dropped
