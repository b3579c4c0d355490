"""chip_smoke.py off the card: it refuses to report without a card or outside
a checkout, and its bound arithmetic counts what the calls need."""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
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


def test_windowed_bound_counts_only_the_keys_in_the_window():
    """A local layer's call: each query sees at most ``window`` keys, and
    K and V are read only over the keys some query sees."""
    _, _, nbytes, flops = chip_smoke.attention_bound(1, 1, 1, 6, 6, 8,
                                                     causal=True, window=2)
    assert flops == 4 * 8 * (1 + 2 + 2 + 2 + 2 + 2)
    assert nbytes == 2 * (2 * 6 * 8 + 2 * 6 * 8)
    # Queries at positions 10 and 11 with a window of 3 see keys 8-10 and
    # 9-11: 6 pairs over 4 keys.
    _, _, nbytes, flops = chip_smoke.attention_bound(
        1, 2, 1, 2, 16, 8, causal=True, q_offset=10, window=3)
    assert flops == 4 * 2 * 8 * 6
    assert nbytes == 2 * (2 * 2 * 2 * 8 + 2 * 4 * 8)
    # The window applies only with causal, as in the kernels.
    assert chip_smoke.attention_bound(1, 1, 1, 4, 4, 8, causal=False,
                                      window=2)[3] == 4 * 8 * 16
    # gemma2's fp32 parity prompt (phase 13): 4,352 tokens against the
    # 4,096-key window skips 256 * 257 / 2 pairs of a global layer's.
    local = chip_smoke.attention_bound(1, 8, 4, 4352, 4352, 256,
                                       causal=True, window=4096,
                                       dtype="float32")
    full = chip_smoke.attention_bound(1, 8, 4, 4352, 4352, 256,
                                      causal=True, dtype="float32")
    assert full[3] - local[3] == 4 * 8 * 256 * (256 * 257 // 2)
    assert local[2] == full[2] and local[1] == full[1] == "operations"


def test_hd256_bounds_at_gemma2_serving_shapes():
    """Phase 12's head-dim-256 rows: the prefill q (4,8,256,256) against
    k,v (4,4,256,256), causal, and a decode step against the (4,4,512,256)
    cache at kv_len 272, bf16; both bound by their bytes."""
    ms, by, nbytes, flops = chip_smoke.attention_bound(
        4, 8, 4, 256, 256, 256, causal=True)
    assert nbytes == 2 * (2 * 4 * 8 * 256 * 256 + 2 * 4 * 4 * 256 * 256)
    assert flops == 4 * 4 * 8 * 256 * (256 * 257 // 2)
    assert by == "bytes" and ms == pytest.approx(0.0038, abs=1e-4)
    ms, by, nbytes, flops = chip_smoke.attention_bound(
        4, 8, 4, 1, 512, 256, causal=False, kv_len=272)
    assert nbytes == 2 * (2 * 4 * 8 * 256 + 2 * 4 * 4 * 272 * 256)
    assert by == "bytes" and ms == pytest.approx(0.0013, abs=1e-4)


def test_wave_launches_count_every_attention_kind():
    """A served wave launches flash_attention once per attention layer,
    local or global, in the prefill, and flash_decode once per attention
    layer in each of its NEW - 1 decode steps; the scans once per layer
    in every pass."""
    import dataclasses

    from repro_torch.configs import get_config
    new = chip_smoke.NEW
    assert chip_smoke.wave_launches(get_config("gemma2-2b")) == {
        "flash_attention": 26, "flash_decode": 26 * (new - 1),
        "mlstm_scan": 0, "mamba_scan": 0}
    assert chip_smoke.wave_launches(get_config("gemma3-4b"))[
        "flash_decode"] == 34 * (new - 1)
    assert chip_smoke.wave_launches(get_config("llama3.2-1b")) == {
        "flash_attention": 16, "flash_decode": 16 * (new - 1),
        "mlstm_scan": 0, "mamba_scan": 0}
    xlstm = get_config("xlstm-125m")
    assert chip_smoke.wave_launches(xlstm) == {
        "flash_attention": 0, "flash_decode": 0,
        "mlstm_scan": xlstm.full_pattern.count("mlstm") * new,
        "mamba_scan": 0}
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=16)
    assert chip_smoke.wave_launches(jamba) == {
        "flash_attention": 2, "flash_decode": 2 * (new - 1),
        "mlstm_scan": 0, "mamba_scan": 14 * new}


def test_phase_11e_launches_every_scan_once_a_layer_a_pass():
    """Phase 11e's DTensor runs, per profile: a prefill and 4 decode steps
    of Jamba at 8 layers (7 mamba, 1 attention) and of xLSTM whole (10
    mLSTM, 2 sLSTM, which has no kernel)."""
    import dataclasses

    from repro_torch.configs import get_config
    steps = chip_smoke.SHARDED_DECODE_STEPS
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"),
                                n_layers=chip_smoke.JAMBA_FP32_LAYERS)
    assert (steps, chip_smoke.JAMBA_FP32_LAYERS) == (4, 8)
    assert chip_smoke.wave_launches(jamba, steps) == {
        "flash_attention": 1, "flash_decode": 4, "mlstm_scan": 0,
        "mamba_scan": 7 * 5}
    assert chip_smoke.wave_launches(get_config("xlstm-125m"), steps) == {
        "flash_attention": 0, "flash_decode": 0, "mlstm_scan": 10 * 5,
        "mamba_scan": 0}
    train = dataclasses.replace(
        get_config("jamba-v0.1-52b"),
        n_layers=chip_smoke.JAMBA_SHARDED_TRAIN_LAYERS)
    assert train.full_pattern == ("mamba", "mamba")
    assert [train.is_moe_layer(i) for i in range(2)] == [False, True]
    assert chip_smoke.spec_elements(train) / 1e9 == pytest.approx(3.74,
                                                                abs=0.01)


def test_wave_launches_of_the_stub_modes_and_qwen3_moe():
    """Phases 18 and 20: qwen2-vl cut to 32 layers and musicgen whole, one
    attention layer each; qwen3-moe's 94 layers would give the same
    pattern."""
    import dataclasses

    from repro_torch.configs import get_config
    new = chip_smoke.NEW
    qwen2vl = dataclasses.replace(get_config("qwen2-vl-72b"),
                                  n_layers=chip_smoke.QWEN2VL_SERVE_LAYERS)
    assert chip_smoke.wave_launches(qwen2vl) == {
        "flash_attention": 32, "flash_decode": 992, "mlstm_scan": 0,
        "mamba_scan": 0}
    assert chip_smoke.wave_launches(get_config("musicgen-medium")) == {
        "flash_attention": 48, "flash_decode": 1488, "mlstm_scan": 0,
        "mamba_scan": 0}
    assert chip_smoke.wave_launches(get_config("qwen3-moe-235b-a22b"))[
        "flash_decode"] == 94 * (new - 1)


def test_decode_floors_of_the_served_models():
    """The bytes a bf16 decode step must read: qwen2-vl at 32 layers reads
    its layers and its untied head (58.7 GB, 17.5 ms), not its embedding
    table nor, with no patch, its frontend; musicgen reads its layers, its
    frame projection and its tied table (3.6 GB, 1.09 ms).  The K/V cache
    at the wave's middle length adds 0.14 and 0.32 GB."""
    import dataclasses

    from repro_torch.configs import get_config
    kv_len = chip_smoke.PROMPT + chip_smoke.NEW // 2
    cfg = dataclasses.replace(get_config("qwen2-vl-72b"), n_layers=32)
    ms, weights, cache = chip_smoke.decode_floor(cfg, 4, kv_len)
    layers = chip_smoke.spec_elements(cfg, layers_only=True)
    assert weights == 2 * (layers + 8192 * 152_064 + 8192)
    assert weights / 1e9 == pytest.approx(58.66, abs=0.01)
    assert cache == 2 * 32 * 2 * 4 * kv_len * 8 * 128
    assert weights / 3.35e12 * 1e3 == pytest.approx(17.51, abs=0.01)
    assert ms == pytest.approx((weights + cache) / 3.35e12 * 1e3)
    mcfg = get_config("musicgen-medium")
    ms, weights, cache = chip_smoke.decode_floor(mcfg, 4, kv_len)
    assert weights == 2 * chip_smoke.spec_elements(mcfg)
    assert weights / 3.35e12 * 1e3 == pytest.approx(1.085, abs=1e-3)
    assert cache == 2 * 48 * 2 * 4 * kv_len * 24 * 64
    llama = get_config("llama3.2-1b")
    assert chip_smoke.decode_floor(llama, 4, kv_len)[1] / 3.35e12 * 1e3 \
        == pytest.approx(0.74, abs=0.01)


def test_kimi_phases_launches_and_expert_floors():
    """Phase 23: kimi-k2 cut to 2 layers launches flash_attention twice in
    the prefill and flash_decode twice a decode step; a bf16 step reads
    all 384 experts' weights in the single-shard MoE (67.7 GB of experts
    of its 70.6 GB, 21.1 ms), and would read 32 of 384 a layer (2.58 ms) if
    only the picked experts were read.  Jamba's floors are the ones phase
    10 logs (15.39 and 8.66 ms)."""
    import dataclasses

    from repro_torch.configs import get_config
    kimi = dataclasses.replace(get_config("kimi-k2-1t-a32b"),
                               n_layers=chip_smoke.KIMI_SERVE_LAYERS)
    assert chip_smoke.wave_launches(kimi) == {
        "flash_attention": 2, "flash_decode": 2 * (chip_smoke.NEW - 1),
        "mlstm_scan": 0, "mamba_scan": 0}
    f = chip_smoke.expert_floors(kimi)
    d, ff = 7168, 2048
    expert = 2 * 3 * d * ff
    assert f["every_bytes"] == chip_smoke.decode_floor(
        kimi, 4, chip_smoke.PROMPT + chip_smoke.NEW // 2)[1]
    assert f["every_bytes"] == 2 * (chip_smoke.spec_elements(kimi)
                                    - kimi.padded_vocab * d)
    assert f["picked"] == 32
    assert f["every_bytes"] - f["picked_bytes"] == 2 * (384 - 32) * expert
    assert f["every_ms"] == pytest.approx(f["every_bytes"] / 3.35e9)
    assert 2 * 384 * expert / 1e9 == pytest.approx(67.65, abs=0.01)
    assert f["every_ms"] == pytest.approx(21.09, abs=0.01)
    assert f["picked_ms"] == pytest.approx(2.58, abs=0.01)
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"),
                                n_layers=chip_smoke.JAMBA_SERVE_LAYERS)
    fj = chip_smoke.expert_floors(jamba)
    assert fj["picked"] == 8
    assert fj["every_ms"] == pytest.approx(15.39, abs=0.01)
    assert fj["picked_ms"] == pytest.approx(8.66, abs=0.01)


def test_prompt_batch_has_each_modes_keys():
    """Token prompts are the earlier phases' (a generator seeded 1); a
    mixed prompt splits as ``batch_specs`` (64 patches and 192 tokens at
    256, none at 1); an embeds prompt is frame embeddings."""
    from repro_torch.configs import get_config
    llama = get_config("llama3.2-1b")
    got = chip_smoke.prompt_batch(llama, 4, 256, "cpu")
    want = torch.randint(0, llama.vocab_size, (4, 256),
                         generator=torch.Generator().manual_seed(1))
    assert list(got) == ["tokens"] and torch.equal(got["tokens"], want)
    vl = get_config("qwen2-vl-72b")
    b = chip_smoke.prompt_batch(vl, 4, 256, "cpu", seed=0)
    assert b["patch_embeds"].shape == (4, 64, 8192)
    assert b["tokens"].shape == (4, 192)
    assert int(b["tokens"].max()) < vl.vocab_size
    one = chip_smoke.prompt_batch(vl, 4, 1, "cpu")
    assert one["patch_embeds"].shape == (4, 0, 8192)
    assert one["tokens"].shape == (4, 1)
    mg = chip_smoke.prompt_batch(get_config("musicgen-medium"), 4, 256,
                                 "cpu", seed=0)
    assert list(mg) == ["frame_embeds"]
    assert mg["frame_embeds"].shape == (4, 256, 1536)
    again = chip_smoke.prompt_batch(get_config("musicgen-medium"), 4, 256,
                                    "cpu", seed=0)
    assert torch.equal(mg["frame_embeds"], again["frame_embeds"])


def test_step_batch_feeds_each_mode():
    from repro_torch.configs import get_config
    tok = torch.tensor([3, 1, 4, 1])
    vl = chip_smoke.step_batch(get_config("qwen2-vl-72b"), tok, 2)
    assert torch.equal(vl["tokens"], tok[:, None])
    assert vl["patch_embeds"].shape == (4, 0, 8192)
    mg = get_config("musicgen-medium")
    s2 = chip_smoke.step_batch(mg, tok, 2)
    assert list(s2) == ["frame_embeds"] and s2["frame_embeds"].shape == \
        (4, 1, 1536)
    assert torch.equal(s2["frame_embeds"],
                       chip_smoke.step_batch(mg, tok, 2)["frame_embeds"])
    assert not torch.equal(s2["frame_embeds"],
                           chip_smoke.step_batch(mg, tok, 3)["frame_embeds"])
    assert list(chip_smoke.step_batch(get_config("llama3.2-1b"), tok, 2)) \
        == ["tokens"]


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-medium",
                                  "llama3.2-1b"])
def test_serve_wave_is_the_generate_loop(arch):
    """On the smoke configs: the stub modes' wave is the prefill and
    greedy decode steps fed ``step_batch``; a token model's is
    ``launch.serve.generate``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeConfig, generate
    from repro_torch.models import init_model, smoke
    cfg = smoke(get_config(arch))
    model = init_model(cfg, 0, device="cpu")
    batch = chip_smoke.prompt_batch(cfg, 2, 12, "cpu", seed=0)
    scfg = ServeConfig(max_new_tokens=5, max_len=20)
    out = chip_smoke.serve_wave(cfg, model, batch, scfg, "cpu", seed=0)
    assert out.shape == (2, 5) and str(out.dtype) == "int32"
    if cfg.input_mode == "tokens":
        np_want = generate(cfg, model, batch["tokens"], scfg, device="cpu")
        assert (out == np_want).all()
        return
    logits, cache, S = model.prefill(batch, 20)
    assert S == 12
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1)
    want = [tok]
    for t in range(1, 5):
        logits, cache = model.decode_step(
            chip_smoke.step_batch(cfg, tok, t, 0), cache, S + t - 1)
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)
        want.append(tok)
    assert (out == torch.stack(want, 1).numpy()).all()
    with pytest.raises(RuntimeError, match="greedy"):
        chip_smoke.serve_wave(cfg, model, batch, dataclasses.replace(
            scfg, temperature=0.8), "cpu")


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


def test_layer_parity_holds_qwen3_moe(monkeypatch):
    """Phase 21's check on the smoke qwen3-moe (qk-norm, an MoE on every
    layer): it passes, and a wrong attention on the kernel path fails it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_model, smoke

    model = init_model(smoke(get_config("qwen3-moe-235b-a22b")), 0,
                       device="cpu")
    prompts = torch.randint(0, 512, (2, 12),
                            generator=torch.Generator().manual_seed(0))
    worst = chip_smoke.layer_parity("qwen3-moe smoke", model, prompts)
    assert 0.0 <= worst["mixer_rel"] <= chip_smoke.MODEL_TOL
    real = ops.attention

    def hot(q, k, v, **kw):
        return real(q * 1.05, k, v, **kw)

    monkeypatch.setattr(ops, "attention", hot)
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.layer_parity("qwen3-moe smoke", model, prompts)


def test_layer_parity_holds_kimi_k2(monkeypatch):
    """Phases 22-23's check on the smoke kimi-k2 (a shared expert beside the
    routed ones) at kimi's head dim 112: it passes, and a wrong attention
    on the kernel path fails it."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_model, smoke

    cfg = dataclasses.replace(smoke(get_config("kimi-k2-1t-a32b")),
                              head_dim=112)
    model = init_model(cfg, 0, device="cpu")
    prompts = torch.randint(0, 512, (2, 12),
                            generator=torch.Generator().manual_seed(0))
    worst = chip_smoke.layer_parity("kimi-k2 smoke", model, prompts)
    assert 0.0 <= worst["mixer_rel"] <= chip_smoke.MODEL_TOL
    real = ops.attention

    def hot(q, k, v, **kw):
        return real(q * 1.05, k, v, **kw)

    monkeypatch.setattr(ops, "attention", hot)
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.layer_parity("kimi-k2 smoke", model, prompts)


# ---------------------------------------------------------------------------
# The training phase's helpers (phase 11)
# ---------------------------------------------------------------------------
def test_train_flops_and_memory_at_full_width():
    """llama3.2-1b at full width, batch 1 x 4,096 tokens, remat "full":
    36.97 TFLOP of model products a step (30.37 + 6.60) and 7.97 of
    recompute (each layer's forward but its FFN down-projection, which
    torch does not rerun), 44.94 executed, the count the dry run's cost
    pass takes (phase 25b holds the card's count to it), 0.67 s at 67
    TFLOP/s fp32; 19.8 GB of parameters, gradients and moments, 2.1 GB of
    one layer's fp32 scores and 2.1 GB of fp32 logits."""
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b")
    assert chip_smoke.spec_elements(cfg) == 1_235_814_400
    assert chip_smoke.spec_elements(cfg) != cfg.param_count() \
        == 1_235_847_168
    # The 33 norm weights of 2,048 enter no product.
    matrices = 1_235_814_400 - 33 * 2048
    assert chip_smoke.spec_elements(cfg, matrices_only=True) == matrices
    f = chip_smoke.train_flops(cfg, 1, 4096)
    assert f["params"] == 6 * matrices * 4096
    assert f["attention"] == 3 * 4 * 32 * 64 * 4096 ** 2 * 16
    assert f["model"] == f["params"] + f["attention"] == 36_966_783_516_672
    assert f["recompute"] == 2 * (matrices - 128_256 * 2048
                                  - 16 * 8192 * 2048) \
        * 4096 + 4 * 32 * 64 * 4096 ** 2 * 16
    assert (f["params"] / 1e12, f["attention"] / 1e12,
            f["recompute"] / 1e12) == pytest.approx((30.37, 6.60, 7.97),
                                                    abs=0.01)
    assert f["total"] == f["model"] + f["recompute"] == 44_938_242_818_048
    assert f["total"] / 67e12 == pytest.approx(0.6707, abs=1e-3)
    none = chip_smoke.train_flops(cfg, 1, 4096, remat="none")
    assert none["recompute"] == 0 and none["total"] == none["model"]
    m = chip_smoke.train_memory_gb(cfg, 1, 4096)
    assert m["state_gb"] == pytest.approx(19.77, abs=0.01)
    assert m["scores_gb"] == pytest.approx(2.147, abs=1e-3)
    assert m["logits_gb"] == pytest.approx(2.101, abs=1e-3)
    assert 30 <= m["estimate_gb"] <= 35


def test_directional_check_holds_the_gradient_and_catches_a_wrong_one():
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


# ---------------------------------------------------------------------------
# Phase 24: the serving engine
# ---------------------------------------------------------------------------
def _bench_knobs(func_name):
    """The keyword arguments of each config call in serve_bench's
    ``func_name``, read from the file's source (no import of benchmarks),
    with ``a if quick else b`` taken as ``a`` and SERVICE_DELAY_MS and the
    function's arguments resolved."""
    import ast
    src = (ROOT / "benchmarks" / "serve_bench.py").read_text()
    tree = ast.parse(src)
    consts = {n.targets[0].id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) and len(n.targets) == 1
              and isinstance(n.targets[0], ast.Name)
              and isinstance(n.value, ast.Constant)}
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == func_name)

    def value(node):
        if isinstance(node, ast.IfExp):          # `a if quick else b`
            return value(node.body)
        if isinstance(node, ast.Name):
            return consts.get(node.id, f"<{node.id}>")
        return ast.literal_eval(node)

    knobs = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id.endswith("Config"):
            knobs.setdefault(node.func.id, {k.arg: value(k.value)
                                            for k in node.keywords
                                            if not isinstance(k.value,
                                                              ast.Call)})
    return knobs


def _assert_knobs(cfg, knobs, skip=()):
    held = 0
    for cls, attr in (("SessionConfig", cfg.session),
                      ("AdmissionConfig", cfg.admission),
                      ("EngineConfig", cfg)):
        for name, want in knobs[cls].items():
            if name in skip or str(want).startswith("<"):
                continue
            assert getattr(attr, name) == want, (cls, name)
            held += 1
    assert held >= 9, knobs          # the source was read, not skipped


@pytest.mark.parametrize("protocol", ["cornus", "2pc"])
def test_engine_pair_config_has_serve_bench_knobs(protocol):
    cfg = chip_smoke.engine_config("pair", {"device": "cpu"}, protocol)
    # Phase 24a drops the deadline (a drop can only mean a fault), runs 64
    # clients and decodes through the kernel.
    _assert_knobs(cfg, _bench_knobs("_cell_config"),
                  skip=("deadline_ms", "clients", "decode"))
    assert cfg.session.protocol == protocol
    assert cfg.admission.deadline_ms is None
    assert cfg.clients == chip_smoke.ENGINE_CLIENTS == 64
    assert cfg.steps_per_session == 30 and cfg.arrival == "closed"
    assert cfg.decode == "kernel" and cfg.decode_kwargs == {"device": "cpu"}


def test_engine_disruption_config_has_serve_bench_knobs():
    cfg = chip_smoke.engine_config("disruption", {"device": "cpu"})
    _assert_knobs(cfg, _bench_knobs("_disruption_config"),
                  skip=("clients", "decode"))
    assert cfg.session.backend == "replicated" and cfg.session.replication == 3
    assert cfg.steps_per_session == 45 and cfg.stall_at == 0.5
    assert cfg.kill_replica_at == cfg.publish_at == 0.33
    assert chip_smoke.ENGINE_SERVICE_DELAY_MS == \
        _bench_knobs("_disruption_config")["SessionConfig"]["service_delay_ms"]
    with pytest.raises(ValueError, match="unknown engine cell"):
        chip_smoke.engine_config("open", {})


def test_engine_decode_geometry_is_llama_decode():
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b")
    d = chip_smoke.ENGINE_DECODE
    assert (d["q_heads"], d["kv_heads"], d["head_dim"]) == \
        (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    assert d["slots"] == chip_smoke.ENGINE_CLIENTS
    pool = 2 * d["slots"] * d["kv_heads"] * d["max_len"] * d["head_dim"] * 2
    assert pool == 536_870_912          # 537 MB of bf16 K and V


def _small_engine(cell, **over):
    """A phase-24 cell cut to the CPU: 8 clients, few steps, a small pool
    of CPU tensors (the plain flash_decode)."""
    import dataclasses

    from repro_torch.serve import ServeEngine
    cfg = chip_smoke.engine_config(
        cell, dict(slots=8, q_heads=4, kv_heads=2, head_dim=16, max_len=64,
                   device="cpu"))
    cfg = dataclasses.replace(cfg, clients=8, steps_per_session=6, **over)
    cfg.session.service_delay_ms = 0.3
    engine = ServeEngine(cfg)
    return engine, engine.run()


@pytest.mark.parametrize("cell", ["pair", "disruption"])
def test_engine_failures_pass_a_good_run_and_flag_faults(cell):
    engine, res = _small_engine(cell)
    good = {"flash_decode": engine.batcher.batches, "flash_attention": 0}
    assert chip_smoke.engine_failures(engine, res, good, cell) == []
    summary = chip_smoke.engine_summary(res)
    assert summary["completed"] == 8 * 6 and summary["p99_ms"] > 0
    # One launch short of the batches: the path skipped the kernel once.
    short = dict(good, flash_decode=engine.batcher.batches - 1)
    assert any("launches" in f for f in
               chip_smoke.engine_failures(engine, res, short, cell))
    # A decode error, a drop and a missing commit are each flagged.
    engine.batcher.last_error = RuntimeError("kernel refused")
    res.report.dropped, res.report.committed = 1, res.report.committed - 1
    fails = chip_smoke.engine_failures(engine, res, good, cell)
    assert any("raised" in f for f in fails)
    assert any("dropped 1" in f for f in fails)
    assert any("committed" in f for f in fails)


def test_engine_failures_need_the_disruption_cells_events():
    engine, res = _small_engine("disruption", publish_at=None,
                                kill_replica_at=None)
    good = {"flash_decode": engine.batcher.batches}
    fails = chip_smoke.engine_failures(engine, res, good, "disruption")
    assert any("replica_killed -1" in f for f in fails)
    assert any("publishes committed" in f for f in fails)
    assert chip_smoke.engine_failures(engine, res, good, "pair") == []


def test_device_ms_by_role_splits_the_kernel_and_the_gathers():
    from types import SimpleNamespace as NS

    def act(name, start, end):
        return NS(name=name, time_range=NS(start=start, end=end))

    acts = [act("void decode_kernel<__nv_bfloat16, 4, 64>(DecodeArgs)",
                0, 30),
            act("void at::native::indexSelectLargeIndex<c10::BFloat16>",
                30, 80),
            act("void at::native::index_put_kernel_impl", 80, 90),
            act("Memcpy HtoD (Pageable -> Device)", 90, 92)]
    roles = chip_smoke.device_ms_by_role(acts)
    assert roles == pytest.approx({"flash_decode": 0.030,
                                   "index_select": 0.050, "other": 0.012})


def test_decode_recorder_holds_what_flash_decode_gave_the_engine():
    from repro_torch.kernels import ops
    kernel = ops.flash_decode
    with chip_smoke.DecodeRecorder() as rec:
        engine, res = _small_engine("pair")
    assert ops.flash_decode is kernel            # unwrapped after the run
    seen = res.counters["max_batch_seen"]
    rows = rec.errors()
    kw = dict(kv_heads=2, max_len=64, head_dim=16)
    assert chip_smoke.decode_failures(rows, kw, seen) == []
    # The first batch of each size and of each kv_len is kept: the first
    # batch of the run attends to one position, none to more than a
    # session's steps.
    sizes, lens = {r["B"] for r in rows}, {r["kv_len"] for r in rows}
    assert max(sizes) == seen > 1 and 1 in lens and max(lens) <= 6
    assert len(rows) <= len(sizes) + len(lens)
    assert all(r["kv_shape"] == (r["B"], 2, 64, 16) for r in rows)
    # A wrong output, K/V off the pool's geometry and a batch size the
    # recorder missed are each flagged.
    rec.records[0]["out"] = rec.records[0]["out"] + 0.1
    assert any("max abs err" in f for f in
               chip_smoke.decode_failures(rec.errors(), kw, seen))
    assert any("K/V" in f for f in chip_smoke.decode_failures(
        rows, dict(kw, max_len=4096), seen))
    assert any("largest batch" in f for f in
               chip_smoke.decode_failures(rows, kw, seen + 1))


def test_p99_gate_is_serve_benchs_check():
    """Each protocol's best (least) p99, cornus within 1.02 x 2pc's
    (benchmarks/serve_bench.py:48, :202-230)."""
    src = (ROOT / "benchmarks" / "serve_bench.py").read_text()
    assert "TRIALS = 3" in src and "P99_SLACK = 1.02" in src
    assert "good = c <= t * P99_SLACK" in src
    assert (chip_smoke.ENGINE_TRIALS, chip_smoke.P99_SLACK) == (3, 1.02)
    gate = chip_smoke.p99_gate({"cornus": [36.6, 35.0, 40.0],
                                "2pc": [34.5, 38.0, 34.4]})
    assert gate["best_p99_ms"] == {"cornus": 35.0, "2pc": 34.4}
    assert gate["limit_ms"] == pytest.approx(34.4 * 1.02)
    assert gate["verdict"] == "ok"                 # 35.0 <= 35.088
    gate = chip_smoke.p99_gate({"cornus": [35.2], "2pc": [34.4]})
    assert gate["verdict"] == "TAIL-INVERTED"      # 35.2 > 35.088
    assert gate["cornus_over_2pc"] == pytest.approx(35.2 / 34.4)


# ---------------------------------------------------------------------------
# Phase 11b: int8 gradient compression in the train step
# ---------------------------------------------------------------------------
def _compressed_step(arch):
    """One compressed step of the smoke config on the CPU under the
    recorder: (cfg, recorder)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import init_model, smoke
    from repro_torch.optim import AdamWConfig, CompressionConfig, adamw_init
    cfg = smoke(get_config(arch))
    model = init_model(cfg, 0, device="cpu")
    opt = adamw_init(dict(model.named_parameters()), AdamWConfig())
    tset = steps.TrainSettings(remat="full", compress=CompressionConfig(),
                               warmup=2)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, 32)))
    allreduce, compress = steps._compressed_allreduce, \
        steps.compress_gradients
    with chip_smoke.CompressRecorder() as rec:
        steps.make_train_step(cfg, tset)(model, opt, {"tokens": toks,
                                                      "labels": toks}, 1)
    assert steps._compressed_allreduce is allreduce     # unwrapped after
    assert steps.compress_gradients is compress
    return cfg, rec


@pytest.mark.parametrize("arch", ["llama3.2-1b", "jamba-v0.1-52b"])
def test_compression_rows_hold_the_steps_codes(arch):
    from repro_torch.convert import jax_layout
    from repro_torch.optim import CompressionConfig
    cfg, rec = _compressed_step(arch)
    names = dict(rec.grads)
    leaves = list(jax_layout(cfg, names))
    # One scale per leaf of the JAX tree: llama's 2 layers stack into one
    # period, so a layer leaf holds both layers' rows.
    assert sorted(rec.codes) == sorted(leaves)
    assert len(leaves) < len(names)
    rows = chip_smoke.compression_rows(cfg, rec.grads, rec.codes,
                                       CompressionConfig())
    assert chip_smoke.compression_failures(rows, leaves) == []
    assert all(r["codes_equal"] and r["scale_equal"] for r in rows)
    assert max(r["err_over_scale"] for r in rows) <= 0.5 + 2.0 ** -16
    assert sum(r["elements"] for r in rows) == sum(
        g.numel() for g in rec.grads.values())
    # A flipped code, a scale an ulp off and a missing leaf are each
    # flagged.
    key = rows[0]["leaf"]
    q, s = rec.codes[key]
    q = q.clone()
    q.view(-1)[0] = q.view(-1)[0] ^ 1
    s2 = torch.nextafter(s, torch.tensor(float("inf")))
    bad = chip_smoke.compression_rows(cfg, rec.grads,
                                      {**rec.codes, key: (q, s2)},
                                      CompressionConfig())
    fails = chip_smoke.compression_failures(bad, leaves)
    assert any("codes differ" in f for f in fails)
    assert any("scale differs" in f for f in fails)
    assert any("leaves compressed" in f for f in
               chip_smoke.compression_failures(rows[1:], leaves))


def test_compression_failures_flag_an_error_over_half_a_step():
    rows = [{"leaf": "w", "codes_equal": True, "scale_equal": True,
             "scale": 1.0, "max_err": 0.5 + 2.0 ** -15,
             "err_over_scale": 0.5 + 2.0 ** -15}]
    assert any("half the scale" in f for f in
               chip_smoke.compression_failures(rows, ["w"]))
    rows[0]["err_over_scale"] = 0.5 + 2.0 ** -17
    assert chip_smoke.compression_failures(rows, ["w"]) == []


def test_host_mesh_phase_on_a_gloo_rank():
    """Phase 11b's mesh half with the CPU's backend: the (1, 1) mesh, the
    specs placed under each profile, one leaf through ``constrain``, and
    the group gone after."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from repro_torch.configs import get_config
    from repro_torch.models import model_specs
    out = chip_smoke.host_mesh_phase(torch, torch.device("cpu"))
    assert not dist.is_initialized()
    assert out["mesh"] == {"shape": [1, 1], "names": ["data", "model"],
                           "device_type": "cpu", "backend": "gloo"}
    n = len(chip_smoke.tree_leaves(model_specs(get_config(chip_smoke.ARCH))))
    assert n == 2 + 16 * 9          # embed (tied), final_ln; 9 a layer
    for profile in ("default", "fsdp", "sp"):
        assert out[profile]["leaves"] == n
        assert out[profile]["fallbacks"] == 0
        # every 2-D leaf sharded on both mesh dims, the norms on one
        assert out[profile]["sharded_mesh_dims"] == 2 * (1 + 16 * 7)
    assert out["constrain"] == [str(Shard(0))] * 2


# ---------------------------------------------------------------------------
# Phase 25: the long prefill against the chunked oracle; the cost pass
# ---------------------------------------------------------------------------
def test_train_flops_is_the_cost_pass_of_phase_11s_step():
    """The executed count phase 11 prints is the meta pass's, the one the
    card's count must equal in phase 25b."""
    from repro_torch.configs import get_config
    cost = chip_smoke.train_cost(torch)
    f = chip_smoke.train_flops(get_config("llama3.2-1b"), chip_smoke.
                               TRAIN_BATCH, chip_smoke.TRAIN_SEQ)
    assert cost["flops"] == f["total"] == 44_938_242_818_048
    assert set(cost["flops_by_op"]) == {"aten.mm", "aten.bmm"}


def test_oracle_failures_flag_each_fault():
    ok = dict(err=1e-3, tol=3e-2, rel_err=3e-3, rel_tol=1e-2, seq=32768,
              chunked_calls=1, peak_bytes=5e9,
              full_scores_bytes=4 * 32 * 32768 ** 2)
    assert chip_smoke.oracle_failures(**ok) == []
    for change, words in ((dict(err=0.5), "max abs err"),
                          (dict(err=float("nan")), "max abs err"),
                          (dict(rel_err=0.04), "block relative err"),
                          (dict(rel_err=float("nan")), "block relative err"),
                          (dict(seq=8192), "threshold"),
                          (dict(chunked_calls=0), "chunked path"),
                          (dict(peak_bytes=2 ** 40), "peak")):
        failed = chip_smoke.oracle_failures(**{**ok, **change})
        assert len(failed) == 1 and words in failed[0], (change, failed)


def test_oracle_failures_on_cpu_tensors(monkeypatch):
    """Phase 25a's comparison at a small threshold on CPU tensors: the
    switch's chunked path counted by ``chunk_calls``, a wrong output and
    an unchunked path each flagged."""
    from repro_torch.kernels import ref
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "CHUNK_THRESHOLD", 64)
    monkeypatch.setattr(layers, "Q_CHUNK", 16)
    monkeypatch.setattr(layers, "KV_CHUNK", 24)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 100, h, 16, generator=gen) for h in (4, 2, 2))
    kernel = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2)).transpose(1, 2)

    def compare(got, seq=100):
        with chip_smoke.chunk_calls() as calls:
            want = layers.attention(q, k, v, causal=True)
        return chip_smoke.oracle_failures(
            chip_smoke.max_err(got, want), 2e-5,
            chip_smoke.block_rel_err(got, want, block=32),
            chip_smoke.LONG_REL_TOL["float32"], seq, calls.calls, 0,
            4 * 4 * 100 * 100)

    assert compare(kernel) == []
    assert "max abs err" in compare(kernel * 1.01)[0]
    monkeypatch.setattr(layers, "CHUNK_THRESHOLD", 1000)
    failed = compare(kernel)
    assert any("chunked path" in f for f in failed)
    assert any("threshold" in f for f in failed)


def test_block_rel_err_is_each_blocks_own_scale():
    """A block's error over the block's own norm; the short last block
    counts, and the measure is the largest block's."""
    want = torch.ones(1, 5, 1, 2)
    got = want.clone()
    got[0, 4] *= 1.5                 # only the last, short block is off
    assert chip_smoke.block_rel_err(got, want, block=2) == \
        pytest.approx(0.5)
    assert chip_smoke.block_rel_err(got, want, block=5) == \
        pytest.approx(0.5 / 5 ** 0.5)
    assert chip_smoke.block_rel_err(want, want) == 0.0


def _weighted_tile_attention(q, k, v, tile, weight, rows=1024):
    """Causal attention in fp32, cast to bf16, in which the keys of
    ``tile`` (start, stop) carry ``weight`` times their softmax weight:
    0 drops the tile, as a kernel that skips one KV tile would; 0.5 is a
    wrong rescale of it.  Computed ``rows`` query rows at a time."""
    import math
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    kk, vv = (t.repeat_interleave(g, dim=2).float() for t in (k, v))
    pos = torch.arange(S)
    out = []
    for r in range(0, S, rows):
        s = torch.einsum("bshd,bthd->bhst", q[:, r:r + rows].float(),
                         kk) / math.sqrt(hd)
        s = s.masked_fill(pos[None, :] > pos[r:r + rows, None],
                          float("-inf"))
        if weight != 1.0:
            s[..., tile[0]:tile[1]] += math.log(weight) if weight \
                else -math.inf
        out.append(torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1),
                                vv))
    return torch.cat(out, dim=1).to(q.dtype)


@pytest.mark.parametrize("fault", ["none", "dropped tile", "tile at half"])
def test_the_long_check_catches_a_fault_late_in_the_chain(monkeypatch,
                                                          fault):
    """Phase 25a's measures at 8,192 causal bf16 tokens on the CPU, with
    blocks of LONG_BLOCK rows, against the chunked oracle: a right
    kernel passes; one that drops a 128-key tile near the end of the
    chain, or weights it by half, moves the late rows (whose outputs are
    small) by less than bf16's 3e-2, and is caught by the block-relative
    measure."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "CHUNK_THRESHOLD", 1024)
    monkeypatch.setattr(layers, "Q_CHUNK", 512)
    monkeypatch.setattr(layers, "KV_CHUNK", 512)
    S, tile = 8192, (7680, 7808)
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(1, S, h, 64, generator=gen).to(torch.bfloat16)
               for h in (2, 1, 1))
    weight = {"none": 1.0, "dropped tile": 0.0, "tile at half": 0.5}[fault]
    got = _weighted_tile_attention(q, k, v, tile, weight)
    with chip_smoke.chunk_calls() as calls:
        want = layers.attention(q, k, v, causal=True)
    assert calls.calls == 1
    err = chip_smoke.max_err(got, want)
    rel = chip_smoke.block_rel_err(got, want)
    failed = chip_smoke.oracle_failures(
        err, chip_smoke.TOL["bfloat16"], rel,
        chip_smoke.LONG_REL_TOL["bfloat16"], S, calls.calls, 0, 1)
    assert err <= chip_smoke.TOL["bfloat16"]
    if fault == "none":
        assert failed == [] and rel < chip_smoke.LONG_REL_TOL["bfloat16"] / 2
    else:
        assert len(failed) == 1 and "block relative err" in failed[0], failed


def test_flop_failures_flag_unequal_counts():
    assert chip_smoke.flop_failures(10, 10, "x") == []
    assert "card" in chip_smoke.flop_failures(10, 11, "x")[0]
    assert chip_smoke.flop_failures(0, 0, "x") != []


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_card_cost_counts_what_the_meta_pass_counts(kind):
    """``card_cost`` on the CPU (phase 25b's route on another device): the
    smoke llama's step of each kind counts the meta pass's products."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import ShapeConfig, smoke
    cfg = smoke(get_config("llama3.2-1b"))
    card, meta = chip_smoke.card_cost(
        torch, torch.device("cpu"), cfg, ShapeConfig(kind, 32, 2, kind),
        steps.TrainSettings(remat="full"), torch.float32)
    assert card == meta["flops"] > 0
    assert chip_smoke.flop_failures(card, meta["flops"], kind) == []


# ---------------------------------------------------------------------------
# Phase 26: the discrete-event half of the commit core
# ---------------------------------------------------------------------------
def test_sim_pinned_values_are_the_reference_s():
    """Every value phase 26 pins is what the JAX package computes for the
    same runs, so the script's constants cannot drift from the
    reference."""
    import repro.core as jcore
    import repro.txn as jtxn

    assert chip_smoke.sim_values(jcore, jtxn) == chip_smoke.SIM_PINNED


def test_sim_phase_holds_the_port_to_the_pinned_values():
    """Phase 26 as the script runs it after the card's phases, here on the
    CPU (it runs no tensor): the port's values equal the pinned ones."""
    got = chip_smoke.sim_phase("cpu")
    assert got == chip_smoke.SIM_PINNED


# ---------------------------------------------------------------------------
# Phase 26b: the "rot" fault mix
# ---------------------------------------------------------------------------
def test_rot_pinned_values_are_the_reference_s():
    """Every value phase 26b pins is what the JAX package computes for the
    same cells."""
    import repro.core as jcore
    import repro.txn as jtxn

    assert chip_smoke.rot_values(jcore, jtxn) == chip_smoke.ROT_PINNED


def test_rot_run_is_the_gc_safety_twin_s():
    """Phase 26b's cells and its copy of benchmarks/chaos.run_one are the
    ones tests/test_torch_gc_safety.py holds against the reference."""
    from test_torch_gc_safety import (REPAIRED, ROT_CELLS, SILENT_SPLITS,
                                      chaos_run_one)

    from repro_torch import core, txn

    assert list(chip_smoke.ROT_CELLS) == ROT_CELLS
    assert sorted((m, r, s) for m, r, s, _h in chip_smoke.REPAIRED_CELLS) \
        == sorted(list(REPAIRED) + list(SILENT_SPLITS))
    assert {h for *_c, h in chip_smoke.REPAIRED_CELLS} == {200.0}
    for proto, mix, replication, seed, horizon in (
            ("2pc", "rot", 3, 1, 300.0), ("2pc", "rot", 1, 61, 200.0),
            ("2pc", "messages", 1, 5, 200.0)):
        got = chip_smoke.chaos_cell(core, txn, proto, mix, replication, seed,
                                    horizon)
        r, _s, _c = chaos_run_one(proto, mix, replication, seed, horizon)
        assert got == (r.commits, r.aborts, r.avg_latency_ms, r.violations,
                       r.gc_truncations)


def test_rot_phase_holds_the_port_to_the_pinned_values():
    """Phase 26b as the script runs it, here on the CPU: the pinned cells
    equal the reference's and the repaired seeds certify."""
    got = chip_smoke.rot_phase("cpu")
    assert {k: got[k] for k in chip_smoke.ROT_PINNED} == chip_smoke.ROT_PINNED
    repaired = {k: v for k, v in got.items() if k.startswith("repaired/")}
    assert len(repaired) == len(chip_smoke.REPAIRED_CELLS)
    for key, (commits, _aborts, _avg, violations, gc_n) in repaired.items():
        assert violations == 0 and commits > 0
        assert gc_n > 0 or "/rot/" not in key
