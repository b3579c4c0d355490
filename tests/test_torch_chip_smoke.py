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
