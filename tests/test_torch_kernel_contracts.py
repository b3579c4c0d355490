"""The contracts of the four kernel wrappers, on the CPU.

Each wrapper states in one function, ``takes``, what its kernel takes; its
``_check`` raises with that function's reason.  Here every head dim, GQA
group, state size, channel count and chunk that the Pallas kernels take is
taken (up to the kernels' limits, which are refused by name), and every
launch plan the wrappers reckon fits the shared memory one block may opt
into on an H100.  The kernels themselves run on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py phase 3).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (decode_attention, flash_attention,  # noqa: E402
                                 mamba_scan, mlstm_scan)

SMEM_LIMIT = 227 * 1024         # 232,448 bytes
DTYPES = [torch.float32, torch.bfloat16]
HEAD_DIMS = range(1, 513)


def refusal(fn):
    """The message of the ValueError ``fn`` raises."""
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_takes_every_head_dim(dtype):
    for hd in HEAD_DIMS:
        assert flash_attention.takes(hd, dtype) is None, hd
        hp = flash_attention.wgmma_width(hd)
        # The first instantiated width past hd: wgmma's K is whole 16-value
        # slices, rows are 32-, 64- or 128-byte blocks, then whole blocks.
        assert hp == min(w for w in flash_attention.WGMMA_WIDTHS if w >= hd)
        assert hp % 16 == 0 and (hp <= 64 or hp % 64 == 0), hd
        ow = flash_attention.out_width(hp)
        assert hp % ow == 0 and ow <= 256, hd    # O: <= 128 registers
        assert flash_attention.wgmma_smem_bytes(hd) <= SMEM_LIMIT, hd
        fw = flash_attention.fp32_width(hd)
        assert fw == min(w for w in flash_attention.FP32_WIDTHS if w >= hd)
    for hd in (0, flash_attention.MAX_HD + 1, 1024):
        assert "MAX_HD = 512" in flash_attention.takes(hd, dtype)
    assert "dtype" in flash_attention.takes(64, torch.float16)


def test_flash_attention_wrapper_checks_with_the_contract():
    """On CPU tensors the wrapper gets as far as the device check at every
    head dim it takes, and refuses hd 513 by its limit: only dtype, shape,
    stride and device are refused besides."""
    for hd in HEAD_DIMS:
        q = torch.zeros((1, 2, 3, hd))
        assert "CUDA" in refusal(
            lambda: flash_attention.flash_attention(q, q[:, :1], q[:, :1]))
    q = torch.zeros((1, 2, 3, 513))
    assert "MAX_HD" in refusal(lambda: flash_attention.flash_attention(q, q,
                                                                       q))


@pytest.mark.parametrize("itemsize", [4, 2])
def test_flash_decode_plans_every_group_and_head_dim(itemsize):
    """Every GQA group from 1 to 128 at every head dim: the group slices
    cover the group, each within one block's registers and threads, and the
    launch fits shared memory; the split covers every key tile once."""
    dtype = DTYPES[itemsize == 2]
    for hd in HEAD_DIMS:
        for g in range(1, 129):
            assert decode_attention.takes(g, hd, dtype) is None
            p = decode_attention.plan(2, 2 * g, 2, hd, 777, itemsize)
            assert (p.slices - 1) * p.group_slice < g, (g, hd)
            assert g <= p.slices * p.group_slice, (g, hd)
            assert p.group_slice <= decode_attention.MAX_ROWS
            assert p.group_slice * 2 * -(-hd // 2) <= \
                decode_attention.MAX_GROUP_HD, (g, hd)
            assert p.smem == decode_attention.smem_bytes(
                p.group_slice, hd, itemsize, p.block_kv) <= SMEM_LIMIT
            assert p.block_kv in (16, 32)
            n_tiles = -(-777 // p.block_kv)
            assert (p.n_split - 1) * p.tiles_per_split < n_tiles <= \
                p.n_split * p.tiles_per_split
    for hd in (0, decode_attention.MAX_HD + 1):
        assert "MAX_HD = 512" in decode_attention.takes(4, hd, dtype)


def test_flash_decode_plan_keeps_the_serving_launch():
    """Where the old kernel took the shape (g·hd <= 2,048), the plan is one
    group slice of 32-key tiles and the old split."""
    for g, hd in ((4, 64), (4, 128), (2, 256), (16, 128), (8, 112), (1, 64)):
        for item in (2, 4):
            p = decode_attention.plan(4, 8 * g, 8, hd, 272, item)
            assert (p.group_slice, p.slices, p.block_kv) == (g, 1, 32)
            assert (p.n_split, p.tiles_per_split) == \
                decode_attention.split_plan(4, 8, 272)


def test_flash_decode_slices_the_public_groups():
    """StarCoder's 48 heads over 1 at hd 128 and Falcon-7B's 71 over 1 at
    hd 64 run as three group slices."""
    assert decode_attention.group_slices(48, 128) == (16, 3)
    assert decode_attention.group_slices(71, 64) == (24, 3)
    assert decode_attention.group_slices(8, 512) == (4, 2)


def test_flash_decode_wrapper_checks_with_the_contract():
    for hd in HEAD_DIMS:
        q = torch.zeros((1, 6, 1, hd), dtype=torch.bfloat16)
        k = torch.zeros((1, 2, 8, hd), dtype=torch.bfloat16)
        assert "CUDA" in refusal(
            lambda: decode_attention.flash_decode(q, k, k, 5))
    for g in range(1, 129):
        q = torch.zeros((1, g, 1, 64))
        k = torch.zeros((1, 1, 8, 64))
        assert "CUDA" in refusal(
            lambda: decode_attention.flash_decode(q, k, k, 5))
    q = torch.zeros((1, 2, 1, 513))
    assert "MAX_HD" in refusal(
        lambda: decode_attention.flash_decode(q, q[:, :1], q[:, :1], 1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_scan_takes_every_state_size_and_channel_count(dtype):
    item = torch.finfo(dtype).bits // 8
    for N in range(1, mamba_scan.MAX_N + 1):
        for di in range(1, 513):
            assert mamba_scan.takes(di, N, dtype) is None, (di, N)
        np_ = mamba_scan.state_width(N)
        assert np_ == min(w for w in mamba_scan.STATE_WIDTHS if w >= N)
        lanes = mamba_scan.lanes_per_channel(np_)
        # Whole states a lane, at most 8 (its registers), lanes within a
        # warp, and whole 16-byte pieces of u and dt a block row.
        assert np_ % lanes == 0 and np_ // lanes <= 8 and 32 % lanes == 0
        assert mamba_scan.channels(N) * item % 16 == 0
        assert mamba_scan.scan_smem_bytes(N, item) <= SMEM_LIMIT, N
    for N in (0, mamba_scan.MAX_N + 1):
        assert "MAX_N = 256" in mamba_scan.takes(64, N, dtype)
    assert "di" in mamba_scan.takes(0, 16, dtype)


def test_mamba_scan_wrapper_checks_with_the_contract():
    def call(di, N):
        u = torch.zeros((1, 3, di))
        bc = torch.zeros((1, 3, N))
        return mamba_scan.mamba_scan(u, u, torch.zeros((di, N)), bc, bc,
                                     torch.zeros((1, di, N)))
    for N in range(1, mamba_scan.MAX_N + 1):
        assert "CUDA" in refusal(lambda: call(37, N))
    for di in range(1, 513):
        assert "CUDA" in refusal(lambda: call(di, 16))
    assert "MAX_N" in refusal(lambda: call(64, 257))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_scan_takes_every_head_dim_and_chunk(dtype):
    for hd in HEAD_DIMS:
        for chunk in (1, 2, 7, 64, 128, 129, 256, 1000):
            assert mlstm_scan.takes(hd, chunk, dtype) is None, (hd, chunk)
        # Some slab width fits the scan kernel's shared memory.
        widths = mlstm_scan.slab_widths(hd)
        assert widths and all(mlstm_scan.scan_smem_bytes(hd, et) <=
                              SMEM_LIMIT for et in widths), hd
        assert mlstm_scan.padded_depth(hd) % 16 == 0
    for hd in (0, mlstm_scan.MAX_HD + 1):
        assert "MAX_HD = 512" in mlstm_scan.takes(hd, 64, dtype)
    assert "chunk" in mlstm_scan.takes(64, 0, dtype)


def test_mlstm_scan_wrapper_checks_with_the_contract():
    def call(hd, chunk=128):
        x = torch.zeros((1, 3, 2, hd))
        g = torch.zeros((1, 3, 2))
        return mlstm_scan.mlstm_scan(x, x, x, g, g,
                                     torch.zeros((1, 2, hd, hd)),
                                     chunk=chunk)
    for hd in HEAD_DIMS:
        assert "CUDA" in refusal(lambda: call(hd))
    assert "CUDA" in refusal(lambda: call(64, chunk=256))
    assert "MAX_HD" in refusal(lambda: call(513))
    assert "chunk" in refusal(lambda: call(64, chunk=0))
