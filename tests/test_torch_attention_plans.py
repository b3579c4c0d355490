"""Host-side plans of the two attention kernels, on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda_kernels.py
and chip_smoke.py); what the CPU reaches is the Python that decides their
grids and shared memory and refuses what they do not take.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention, flash_attention  # noqa: E402

# Dynamic shared memory one block may opt into on an H100 (232,448 bytes).
SMEM_LIMIT = 227 * 1024

# llama3.2-1b and Jamba serve 4 requests against a (4, 8, 512, hd) cache.
SERVING = (4, 8, 512)
# Blocks of the decode grid at the serving cache, by kv_len.
SERVING_BLOCKS = {1: 32, 64: 64, 272: 288, 512: 256}
SHAPES = [SERVING, (1, 8, 4096), (3, 2, 1000), (2, 1, 96)]
PLANS = [(shape, kv_len) for shape in SHAPES
         for kv_len in sorted({1, 64, 272, 512, shape[2]})
         if kv_len <= shape[2]]


@pytest.mark.parametrize("shape,kv_len", PLANS, ids=str)
def test_split_plan_covers_every_tile_once(shape, kv_len):
    batch, kv_heads, T = shape
    n_split, per = decode_attention.split_plan(batch, kv_heads, kv_len)
    n_tiles = -(-kv_len // decode_attention.BLOCK_KV)
    covered = []
    for s in range(n_split):
        tiles = list(range(s * per, min((s + 1) * per, n_tiles)))
        assert tiles, f"split {s} of {n_split} is empty"
        covered += tiles
    assert covered == list(range(n_tiles))
    blocks = batch * kv_heads * n_split
    assert blocks < decode_attention.TARGET_BLOCKS + batch * kv_heads
    if shape == SERVING and kv_len in SERVING_BLOCKS:
        assert blocks == SERVING_BLOCKS[kv_len]
        # The whole split is in flight at once at the serving shapes.
        assert per <= decode_attention.STAGES


def test_flash_attention_smem_fits_every_head_dim():
    for hd in flash_attention.WGMMA_WIDTHS:
        need = flash_attention.wgmma_smem_bytes(hd)
        # Q, two stages of K, all in bf16, and two stages of the block's
        # columns of V fit beside the alignment.
        ow = flash_attention.out_width(hd)
        q_tile = flash_attention.BLOCK_Q * hd * 2
        kv_stages = 2 * flash_attention.BLOCK_KV * (hd + ow) * 2
        assert q_tile + kv_stages < need <= SMEM_LIMIT, hd
        # Blocks that share an SM: at least four up to hd 128, so the
        # llama and Jamba serving grids (512 blocks) are resident at once;
        # two at hd 256, where gemma2's serving grid (4 q tiles x 8 heads x
        # batch 4 = 128 blocks) still is, on the H100's 132 SMs; at least
        # one at the widest.
        per_sm = SMEM_LIMIT // need
        if hd <= 128:
            assert per_sm >= 4, hd
        elif hd == 256:
            assert per_sm == 2, hd
            assert 4 * 8 * 4 <= per_sm * 132
        else:
            assert per_sm >= 1, hd


def test_flash_attention_lays_head_dim_112_out_at_128():
    """A 224-byte bf16 row is not whole 128-byte column blocks: the tiles
    take the padded width of 128, so the shared memory reckoned is hd
    128's, 50,176 bytes, and every instantiated width keeps its own."""
    assert flash_attention.wgmma_width(112) == 128
    assert flash_attention.wgmma_smem_bytes(112) == \
        flash_attention.wgmma_smem_bytes(128) == 50_176
    for hd in flash_attention.WGMMA_WIDTHS:
        assert flash_attention.wgmma_width(hd) == hd
        assert flash_attention.wgmma_width(hd) * 2 % min(hd * 2, 128) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_smem_fits_every_group(dtype):
    item = torch.finfo(dtype).bits // 8
    for hd in (16, 32, 64, 80, 96, 112, 128, 256, 320, 512):
        for g in (1, 2, 4, 8, 16, 24, 48, 71):
            # The group runs as slices whose outputs fit one block.
            gs, slices = decode_attention.group_slices(g, hd)
            assert gs * slices >= g
            assert gs * hd <= decode_attention.MAX_GROUP_HD
            p = decode_attention.plan(4, g, 1, hd, 512, item)
            assert decode_attention.smem_bytes(
                gs, hd, item, p.block_kv) == p.smem <= SMEM_LIMIT


def _qkv(dtype, Sq=8, Skv=64, hd=64):
    q = torch.zeros((1, 4, Sq, hd), dtype=dtype)
    k = torch.zeros((1, 2, Skv, hd), dtype=dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("kernel", ["flash_attention", "flash_decode"])
def test_wrappers_refuse_cpu_tensors_and_bad_inputs(kernel):
    def call(q, k, v):
        if kernel == "flash_attention":
            return flash_attention.flash_attention(q, k, v)
        return decode_attention.flash_decode(q[:, :, :1], k, v, 10)

    with pytest.raises(ValueError, match="CUDA"):
        call(*_qkv(torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        call(*_qkv(torch.float32))
    with pytest.raises(ValueError, match="dtypes"):
        call(*_qkv(torch.float16))
    q, k, v = _qkv(torch.bfloat16)
    with pytest.raises(ValueError, match="dtypes"):
        call(q, k, v.float())
    # K/V rows 136 bytes apart, and K/V starting 2 bytes past 16-byte
    # alignment: the kernels read such rows with narrower loads, so the
    # wrappers take them (and refuse only the CPU tensors).
    wide = torch.zeros((1, 2, 64, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="CUDA"):
        call(q, wide, wide)
    flat = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 2, 64, 64)
    with pytest.raises(ValueError, match="CUDA"):
        call(q, shifted, shifted)
    with pytest.raises(ValueError, match="stride 1"):
        call(q, k.transpose(2, 3), v.transpose(2, 3))
