"""The port's CUDA kernels against their plain PyTorch version, on the card.

These tests need an NVIDIA card (the kernels have no CPU mode) and skip
without one.  They import no JAX, so the machine with the card runs them:
    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
"""
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import (ATTN_SWEEP, DECODE_SWEEP, MAMBA_H_TOL,  # noqa: E402
                        MAMBA_SWEEP, MLSTM_C_TOL, MLSTM_SWEEP, TOL)
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


def mamba_inputs(seed, B, S, di, N, dtype, device, h0_scale=0.0):
    """u, dt, a, b, c, h0 as tests/test_kernels.py makes them."""
    u = randn(seed, (B, S, di), dtype, device)
    dt = torch.nn.functional.softplus(
        randn(seed + 1, (B, S, di), "float32", device)).to(DT[dtype])
    a = -torch.exp(randn(seed + 2, (di, N), "float32", device) * 0.5)
    b = randn(seed + 3, (B, S, N), dtype, device)
    c = randn(seed + 4, (B, S, N), dtype, device)
    h0 = randn(seed + 5, (B, di, N), "float32", device) * h0_scale
    return u, dt, a, b, c, h0


def hold_mamba(inputs, dtype, out=None):
    ops.reset_launch_counts()
    y, h = ops.selective_scan(*inputs, out=out)
    assert ops.launch_counts()["mamba_scan"] == 1
    u = inputs[0]
    assert y.dtype == u.dtype and y.shape == u.shape
    assert h.dtype == torch.float32
    want_y, want_h = ref.mamba_scan_ref(*inputs)
    torch.testing.assert_close(y.float(), want_y, rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(h, want_h, rtol=MAMBA_H_TOL, atol=MAMBA_H_TOL)
    return y, h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MAMBA_SWEEP)
def test_mamba_scan_matches_ref(case, dtype, cuda):
    B, S, di, N, _ = case
    hold_mamba(mamba_inputs(40, B, S, di, N, dtype, cuda, 0.3), dtype)


@pytest.mark.parametrize("shape", [(4, 256, 8192, 16), (4, 1, 8192, 16)],
                         ids=["prefill", "decode"])
def test_mamba_scan_serving_shapes(shape, cuda):
    """Jamba's mixer as served, fp32: the prefill from a zero state, a
    decode step updating a nonzero state in place."""
    B, S, di, N = shape
    u, dt, a, b, c, h0 = mamba_inputs(50, B, S, di, N, "float32", cuda,
                                      0.0 if S > 1 else 0.5)
    want_y, want_h = ref.mamba_scan_ref(u, dt, a, b, c, h0)
    y, h = ops.selective_scan(u, dt, a, b, c, h0, out=h0)
    assert h is h0
    torch.testing.assert_close(y, want_y, rtol=TOL["float32"],
                               atol=TOL["float32"])
    torch.testing.assert_close(h, want_h, rtol=TOL["float32"],
                               atol=TOL["float32"])


def test_mamba_scan_carries_state_across_calls(cuda):
    u, dt, a, b, c, h0 = mamba_inputs(60, 2, 200, 256, 16, "float32", cuda,
                                      0.3)
    y, h = ops.selective_scan(u, dt, a, b, c, h0)
    y1, h1 = ops.selective_scan(u[:, :77], dt[:, :77], a, b[:, :77],
                                c[:, :77], h0)
    y2, h2 = ops.selective_scan(u[:, 77:], dt[:, 77:], a, b[:, 77:],
                                c[:, 77:], h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h2, h, rtol=1e-5, atol=1e-5)


def test_flash_attention_jamba_prefill_shape(cuda):
    """Head dim 128 at Jamba's prefill, in the model's (B,S,N,hd) layout."""
    for dtype in ("float32", "bfloat16"):
        q = randn(10, (4, 256, 32, 128), dtype, cuda).transpose(1, 2)
        k = randn(11, (4, 256, 8, 128), dtype, cuda).transpose(1, 2)
        v = randn(12, (4, 256, 8, 128), dtype, cuda).transpose(1, 2)
        torch.testing.assert_close(
            ops.flash_attention(q, k, v).float(),
            ref.attention_ref(q, k, v).float(), rtol=TOL[dtype],
            atol=TOL[dtype])


def model_views(seed, B, S, N, hd, dtype, device):
    """A (B,S,N,hd) activation or cache seen as the model passes it: the
    (B,N,S,hd) ``transpose(1, 2)`` view."""
    return randn(seed, (B, S, N, hd), dtype, device).transpose(1, 2)


@pytest.mark.parametrize("hd,hq,hkv,cap", [(64, 32, 8, 0.0),
                                           (128, 32, 8, 0.0),
                                           (256, 8, 4, 50.0),
                                           (112, 64, 8, 0.0)],
                         ids=["llama", "jamba", "gemma2", "kimi"])
def test_attention_kernels_at_the_serving_shapes(hd, hq, hkv, cap, cuda):
    """bf16 prefill (4 x 256 tokens, hq q heads, hkv KV heads, gemma2's
    softcap) and a decode step against the (4, 512, hkv, hd) cache at
    kv_len 272, all as views."""
    q = model_views(70, 4, 256, hq, hd, "bfloat16", cuda)
    k = model_views(71, 4, 256, hkv, hd, "bfloat16", cuda)
    v = model_views(72, 4, 256, hkv, hd, "bfloat16", cuda)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=True, softcap=cap).float(),
        ref.attention_ref(q, k, v, causal=True, softcap=cap).float(),
        rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    qd = model_views(73, 4, 1, hq, hd, "bfloat16", cuda)
    kc = model_views(74, 4, 512, hkv, hd, "bfloat16", cuda)
    vc = model_views(75, 4, 512, hkv, hd, "bfloat16", cuda)
    torch.testing.assert_close(
        ops.flash_decode(qd, kc, vc, 272, softcap=cap).float(),
        ref.attention_ref(qd, kc, vc, causal=False, softcap=cap,
                          kv_len=272).float(),
        rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_window_at_gemma2_length(dtype, cuda):
    """gemma2's local layer over one 4,352-token prompt (phase 13's): the
    4,096-key window makes the last query tiles skip their first key
    tiles; head dim 256, g = 2, softcap 50."""
    q = model_views(76, 1, 4352, 8, 256, dtype, cuda)
    k = model_views(77, 1, 4352, 4, 256, dtype, cuda)
    v = model_views(78, 1, 4352, 4, 256, dtype, cuda)
    kw = dict(causal=True, window=4096, softcap=50.0)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, **kw).float(),
        ref.attention_ref(q, k, v, **kw).float(),
        rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("hd", [64, 112, 128, 256])
def test_flash_attention_offset_and_kv_len_bf16(hd, cuda):
    """A chunk of 80 queries at q_offset 100 against 256 keys of which 170
    are valid, causal and not, with a window and a softcap."""
    q = model_views(80, 2, 80, 8, hd, "bfloat16", cuda)
    k = model_views(81, 2, 256, 2, hd, "bfloat16", cuda)
    v = model_views(82, 2, 256, 2, hd, "bfloat16", cuda)
    for kw in (dict(causal=True, q_offset=100, kv_len=170),
               dict(causal=False, q_offset=100, kv_len=170),
               dict(causal=True, q_offset=100, kv_len=170, window=40,
                    softcap=30.0)):
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, **kw).float(),
            ref.attention_ref(q, k, v, **kw).float(),
            rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 96], ids=["causal", "windowed"])
def test_attention_kernels_at_head_dim_112(window, dtype, cuda):
    """kimi-k2's head dim 112 with its GQA group of 8 (16 q heads, 2 KV
    heads): a ragged causal prefill of 130 queries (three q tiles, the last
    of 2 rows), with and without a window; a chunk at q_offset 40 against
    200 keys of which 171 are valid; decode steps at ragged kv_len.  The
    bf16 kernel lays the 112 dims out at 128 with zeros, so the padding
    must not reach the output."""
    q = model_views(120, 2, 130, 16, 112, dtype, cuda)
    k = model_views(121, 2, 130, 2, 112, dtype, cuda)
    v = model_views(122, 2, 130, 2, 112, dtype, cuda)
    kw = dict(causal=True, window=window)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, **kw).float(),
        ref.attention_ref(q, k, v, **kw).float(),
        rtol=TOL[dtype], atol=TOL[dtype])
    kc = model_views(123, 2, 200, 2, 112, dtype, cuda)
    vc = model_views(124, 2, 200, 2, 112, dtype, cuda)
    kw = dict(causal=True, window=window, q_offset=40, kv_len=171)
    torch.testing.assert_close(
        ops.flash_attention(q[:, :, :90], kc, vc, **kw).float(),
        ref.attention_ref(q[:, :, :90], kc, vc, **kw).float(),
        rtol=TOL[dtype], atol=TOL[dtype])
    qd = model_views(125, 2, 1, 16, 112, dtype, cuda)
    for kv_len in (1, 33, 171, 200):
        torch.testing.assert_close(
            ops.flash_decode(qd, kc, vc, kv_len).float(),
            ref.attention_ref(qd, kc, vc, causal=False,
                              kv_len=kv_len).float(),
            rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_one_split_and_the_most_splits(dtype, cuda):
    from repro_torch.kernels.decode_attention import split_plan
    B, Hkv, T, hd = 4, 8, 512, 64
    plans = {n: split_plan(B, Hkv, n)[0] for n in range(1, T + 1)}
    most = max(plans, key=plans.get)
    assert plans[1] == 1 and plans[most] > 1
    qd = model_views(90, B, 1, 32, hd, dtype, cuda)
    kc = model_views(91, B, T, Hkv, hd, dtype, cuda)
    vc = model_views(92, B, T, Hkv, hd, dtype, cuda)
    for kv_len in (1, most):
        torch.testing.assert_close(
            ops.flash_decode(qd, kc, vc, kv_len).float(),
            ref.attention_ref(qd, kc, vc, causal=False,
                              kv_len=kv_len).float(),
            rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_decode_repeats_bitwise(cuda):
    """The merge's tickets are back at zero after every call: the same call
    twice, and two batch shapes in turn, give bitwise-equal outputs."""
    def inputs(seed, B):
        return (model_views(seed, B, 1, 32, 128, "bfloat16", cuda),
                model_views(seed + 1, B, 512, 8, 128, "bfloat16", cuda),
                model_views(seed + 2, B, 512, 8, 128, "bfloat16", cuda))

    big, small = inputs(100, 4), inputs(110, 2)
    first = ops.flash_decode(*big, 272)
    assert torch.equal(ops.flash_decode(*big, 272), first)
    first_small = ops.flash_decode(*small, 500)
    for _ in range(3):
        assert torch.equal(ops.flash_decode(*big, 272), first)
        assert torch.equal(ops.flash_decode(*small, 500), first_small)
    torch.testing.assert_close(
        first.float(), ref.attention_ref(*big, causal=False,
                                         kv_len=272).float(),
        rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """The shapes the kernels once refused (hd 48 and 96 in attention, hd
    40 in the mLSTM, N = 12 at di 32 in the selective scan) now run, each
    with one launch; what is refused is the contracts' limits (hd 513, N
    257), a dtype, a kv_len and a DTensor."""
    for hd in (48, 96):
        q = torch.randn((1, 4, 8, hd), device=cuda)
        ops.reset_launch_counts()
        torch.testing.assert_close(ops.flash_attention(q, q, q),
                                   ref.attention_ref(q, q, q),
                                   rtol=TOL["float32"], atol=TOL["float32"])
        assert ops.launch_counts()["flash_attention"] == 1
    x = torch.randn((1, 8, 2, 40), device=cuda)            # head_dim 40
    g = torch.sigmoid(torch.randn((1, 8, 2), device=cuda))
    c0 = torch.zeros((1, 2, 40, 40), device=cuda)
    ops.reset_launch_counts()
    y, _ = ops.mlstm(x, x, x, g, g, c0)
    assert ops.launch_counts()["mlstm_scan"] == 1
    torch.testing.assert_close(
        y, ref.mlstm_ref(x, x, x, g, g, c0, c0[..., 0])[0],
        rtol=TOL["float32"], atol=TOL["float32"])
    u = torch.randn((1, 8, 32), device=cuda)
    bc = torch.randn((1, 8, 12), device=cuda)                # N = 12
    a = -torch.ones((32, 12), device=cuda)
    h0 = torch.zeros((1, 32, 12), device=cuda)
    ops.reset_launch_counts()
    y, _ = ops.selective_scan(u, u.abs(), a, bc, bc, h0)
    assert ops.launch_counts()["mamba_scan"] == 1
    torch.testing.assert_close(
        y, ref.mamba_scan_ref(u, u.abs(), a, bc, bc, h0)[0],
        rtol=TOL["float32"], atol=TOL["float32"])

    q = torch.zeros((1, 4, 8, 513), device=cuda)
    with pytest.raises(ValueError, match="MAX_HD"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="MAX_HD"):
        ops.flash_decode(q[:, :, :1], q, q, 1)
    x = torch.zeros((1, 8, 2, 513), device=cuda)
    with pytest.raises(ValueError, match="MAX_HD"):
        ops.mlstm(x, x, x, g, g, torch.zeros((1, 2, 513, 513), device=cuda))
    bc = torch.zeros((1, 8, 257), device=cuda)
    with pytest.raises(ValueError, match="MAX_N"):
        ops.selective_scan(u, u, torch.zeros((32, 257), device=cuda), bc, bc,
                           torch.zeros((1, 32, 257), device=cuda))
    q = torch.zeros((1, 4, 1, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        ops.flash_decode(q, q, q, 1)
    q = torch.zeros((1, 4, 1, 64), device=cuda)
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_decode(q, q, q, 2)


# ---------------------------------------------------------------------------
# The scans as redesigned for Hopper: the mLSTM normalizer, the serving
# shapes in both dtypes, carried and in-place states, repeats, refusals
# ---------------------------------------------------------------------------
def mlstm_inputs(seed, B, S, H, hd, dtype, device, k_scale=1.0):
    """q, k, v, i, f as the model makes them (k scaled by 1/sqrt(hd) at the
    serving width, the forget gate biased toward remembering)."""
    q = randn(seed, (B, S, H, hd), dtype, device)
    k = (randn(seed + 1, (B, S, H, hd), "float32", device) * k_scale).to(
        DT[dtype])
    v = randn(seed + 2, (B, S, H, hd), dtype, device)
    i = torch.sigmoid(randn(seed + 3, (B, S, H), "float32", device))
    f = torch.sigmoid(randn(seed + 4, (B, S, H), "float32", device) + 2.0)
    return q, k, v, i.to(DT[dtype]), f.to(DT[dtype])


def hold_mlstm(inp, c0, n0, dtype, chunk=128, in_place=False):
    """One ops.mlstm call with n0 against ref.mlstm_ref: y at TOL, C and n
    at MLSTM_C_TOL."""
    want_y, want_c, want_n = ref.mlstm_ref(*inp, c0, n0)
    c_in, n_in = (c0.clone(), n0.clone()) if in_place else (c0, n0)
    ops.reset_launch_counts()
    y, c, n = ops.mlstm(*inp, c_in, n0=n_in, chunk=chunk,
                        out=c_in if in_place else None,
                        n_out=n_in if in_place else None)
    assert ops.launch_counts()["mlstm_scan"] == 1
    if in_place:
        assert c is c_in and n is n_in
    assert y.dtype == inp[0].dtype and n.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y, rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(c, want_c, rtol=MLSTM_C_TOL[dtype],
                               atol=MLSTM_C_TOL[dtype])
    torch.testing.assert_close(n, want_n, rtol=MLSTM_C_TOL[dtype],
                               atol=MLSTM_C_TOL[dtype])
    return y, c, n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLSTM_SWEEP)
def test_mlstm_normalizer_matches_ref(case, dtype, cuda):
    B, S, H, hd, chunk = case
    inp = mlstm_inputs(36, B, S, H, hd, dtype, cuda)
    c0 = randn(37, (B, H, hd, hd), "float32", cuda) * 0.3
    n0 = randn(38, (B, H, hd), "float32", cuda) * 0.3
    hold_mlstm(inp, c0, n0, dtype, chunk=chunk)
    hold_mlstm(inp, c0, n0, dtype, chunk=1)          # the step kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [256, 1], ids=["prefill", "decode"])
def test_mlstm_scan_serving_shapes(S, dtype, cuda):
    """xlstm-125m's mLSTM as served: (4, S, 4, 384), the prefill from a
    zero state, a decode step updating nonzero C and n in place."""
    B, H, hd = 4, 4, 384
    inp = mlstm_inputs(140, B, S, H, hd, dtype, cuda, k_scale=hd ** -0.5)
    scale = 0.0 if S > 1 else 0.1
    c0 = randn(141, (B, H, hd, hd), "float32", cuda) * scale
    n0 = randn(142, (B, H, hd), "float32", cuda) * scale
    hold_mlstm(inp, c0, n0, dtype, in_place=S == 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_scan_widest_head(dtype, cuda):
    """hd 448: the 48-column slab no longer fits shared memory, so the
    scan kernel takes 32 columns; a ragged second chunk, then one decode
    step from the carried state."""
    B, S, H, hd = 1, 150, 2, 448
    inp = mlstm_inputs(155, B, S, H, hd, dtype, cuda, k_scale=hd ** -0.5)
    c0 = randn(156, (B, H, hd, hd), "float32", cuda) * 0.1
    n0 = randn(157, (B, H, hd), "float32", cuda) * 0.1
    _, c, n = hold_mlstm(inp, c0, n0, dtype)
    step = mlstm_inputs(158, B, 1, H, hd, dtype, cuda, k_scale=hd ** -0.5)
    hold_mlstm(step, c, n, dtype, in_place=True)


def test_mlstm_scan_carries_c_and_n_across_calls(cuda):
    inp = mlstm_inputs(150, 2, 300, 2, 64, "float32", cuda)
    c0 = randn(151, (2, 2, 64, 64), "float32", cuda) * 0.3
    n0 = randn(152, (2, 2, 64), "float32", cuda) * 0.3
    y, c, n = ops.mlstm(*inp, c0, n0=n0)
    y1, c1, n1 = ops.mlstm(*(t[:, :131] for t in inp), c0, n0=n0)
    y2, c2, n2 = ops.mlstm(*(t[:, 131:] for t in inp), c1, n0=n1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(c2, c, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(n2, n, rtol=1e-5, atol=1e-5)


def test_scan_decode_steps_repeat_bitwise(cuda):
    """The same decode step twice gives bitwise-equal outputs and states
    (no atomics, no order that changes from run to run)."""
    inp = mlstm_inputs(160, 4, 1, 4, 384, "float32", cuda, 384 ** -0.5)
    c0 = randn(161, (4, 4, 384, 384), "float32", cuda) * 0.1
    n0 = randn(162, (4, 4, 384), "float32", cuda) * 0.1
    first = ops.mlstm(*inp, c0, n0=n0)
    for _ in range(2):
        for got, want in zip(ops.mlstm(*inp, c0, n0=n0), first):
            assert torch.equal(got, want)
    m = mamba_inputs(163, 4, 1, 8192, 16, "float32", cuda, 0.5)
    first = ops.selective_scan(*m)
    for _ in range(2):
        for got, want in zip(ops.selective_scan(*m), first):
            assert torch.equal(got, want)


@pytest.mark.parametrize("S", [256, 1], ids=["prefill", "decode"])
def test_mamba_scan_serving_shapes_bf16(S, cuda):
    """Jamba's mixer at the serving shapes with bf16 u, dt, b, c: y at the
    bf16 tolerance, the fp32 state at MAMBA_H_TOL, updated in place."""
    u, dt, a, b, c, h0 = mamba_inputs(170, 4, S, 8192, 16, "bfloat16", cuda,
                                      0.0 if S > 1 else 0.5)
    want_y, want_h = ref.mamba_scan_ref(u, dt, a, b, c, h0)
    y, h = ops.selective_scan(u, dt, a, b, c, h0, out=h0)
    assert h is h0 and y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), want_y, rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])
    torch.testing.assert_close(h, want_h, rtol=MAMBA_H_TOL, atol=MAMBA_H_TOL)


def test_scan_wrappers_refuse_what_the_redesigned_kernels_do_not_take(cuda):
    x = torch.zeros((1, 8, 2, 32), device=cuda)
    g = torch.zeros((1, 8, 2), device=cuda)
    c0 = torch.zeros((1, 2, 32, 32), device=cuda)
    n0 = torch.zeros((1, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="n_out needs n0"):
        ops.mlstm(x, x, x, g, g, c0, n_out=n0)
    with pytest.raises(ValueError, match="n0 and n_out must be"):
        ops.mlstm(x, x, x, g, g, c0, n0=n0[..., :16])
    # Rows 4 bytes past 16-byte alignment and di = 96 (not a multiple of
    # 64) are taken now: the kernels read such rows with narrower loads
    # and predicate the channel tail.
    odd = torch.zeros(1 + x.numel(), device=cuda)[1:].view(x.shape)
    ops.reset_launch_counts()
    y, _ = ops.mlstm(odd, x, x, g, g, c0)
    assert ops.launch_counts()["mlstm_scan"] == 1 and not y.any()
    bc = torch.zeros((1, 8, 16), device=cuda)
    for u in (torch.zeros((1, 8, 96), device=cuda),
              torch.zeros(1 + 8 * 64, device=cuda)[1:].view(1, 8, 64)):
        di = u.shape[-1]
        y, h = ops.selective_scan(u, u, torch.zeros((di, 16), device=cuda),
                                  bc, bc, torch.zeros((1, di, 16),
                                                      device=cuda))
        assert y.shape == u.shape and not y.any() and not h.any()
