"""The port's CUDA kernels against their plain PyTorch version, on the card.

These tests need an NVIDIA card (the kernels have no CPU mode) and skip
without one.  They import no JAX, so the machine with the card runs them:
    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
"""
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import (ATTN_SWEEP, DECODE_SWEEP, MLSTM_C_TOL,  # noqa: E402
                        MLSTM_SWEEP, TOL)
from repro_torch.kernels import ops, ref  # noqa: E402

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def randn(seed, shape, dtype, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=DT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_SWEEP)
def test_flash_attention_matches_ref(case, dtype, cuda):
    B, Hq, Hkv, Sq, Skv, hd, causal, window, cap = case
    q = randn(1, (B, Hq, Sq, hd), dtype, cuda)
    k = randn(2, (B, Hkv, Skv, hd), dtype, cuda)
    v = randn(3, (B, Hkv, Skv, hd), dtype, cuda)
    kw = dict(causal=causal, window=window, softcap=cap)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               ref.attention_ref(q, k, v, **kw).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_SWEEP)
def test_flash_decode_matches_ref(case, dtype, cuda):
    B, Hq, Hkv, T, hd, kv_len, cap = case
    q = randn(7, (B, Hq, 1, hd), dtype, cuda)
    k = randn(8, (B, Hkv, T, hd), dtype, cuda)
    v = randn(9, (B, Hkv, T, hd), dtype, cuda)
    ops.reset_launch_counts()
    got = ops.flash_decode(q, k, v, kv_len, softcap=cap)
    assert ops.launch_counts()["flash_decode"] == 1
    want = ref.attention_ref(q, k, v, causal=False, softcap=cap,
                             kv_len=kv_len)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLSTM_SWEEP)
def test_mlstm_scan_matches_ref(case, dtype, cuda):
    B, S, H, hd, chunk = case
    q = randn(30, (B, S, H, hd), dtype, cuda)
    k = randn(31, (B, S, H, hd), dtype, cuda)
    v = randn(32, (B, S, H, hd), dtype, cuda)
    i = torch.sigmoid(randn(33, (B, S, H), "float32", cuda)).to(DT[dtype])
    f = torch.sigmoid(randn(34, (B, S, H), "float32", cuda) + 2.0).to(
        DT[dtype])
    c0 = randn(35, (B, H, hd, hd), "float32", cuda) * 0.3
    ops.reset_launch_counts()
    y, c_last = ops.mlstm(q, k, v, i, f, c0, chunk=chunk)
    assert ops.launch_counts()["mlstm_scan"] == 1
    assert y.dtype == q.dtype and c_last.dtype == torch.float32
    want_y, want_c, _ = ref.mlstm_ref(q, k, v, i, f, c0,
                                      torch.zeros((B, H, hd), device=cuda))
    torch.testing.assert_close(y.float(), want_y, rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(c_last, want_c, rtol=MLSTM_C_TOL[dtype],
                               atol=MLSTM_C_TOL[dtype])


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 4, 8, 48), device=cuda)          # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q, q)
    q = torch.zeros((1, 4, 1, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        ops.flash_decode(q, q, q, 1)
    q = torch.zeros((1, 4, 1, 64), device=cuda)
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_decode(q, q, q, 2)
    x = torch.zeros((1, 8, 2, 40), device=cuda)           # head_dim 40
    g = torch.zeros((1, 8, 2), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.mlstm(x, x, x, g, g, torch.zeros((1, 2, 40, 40), device=cuda))
