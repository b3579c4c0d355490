"""The kernel wrappers on DTensors, on the CPU.

* ``ops.flash_attention``, ``flash_decode``, ``selective_scan`` and
  ``mlstm`` raise ``TypeError`` when handed a DTensor, before any launch
  code reads a pointer and before the CPU branch could compute on a
  DTensor's storage.
* ``ops.attention`` on DTensors runs on each rank's local shards: at
  TP = 2, a rank holding a block of q heads (``Shard(2)`` on "model") and
  the whole K and V attends its heads with the KV heads of their GQA
  groups, through the plain versions here; its output is its block of the
  whole attention's, for GQA groups that a rank's block fills, splits or
  straddles.

Each case runs as rank r of a fake process group of two (the "fake"
backend of ``torch.testing``: no other rank exists and no collective
moves data), which the test destroys.  The placements given match the
ones the call keeps, so the local-shard path issues no collective.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = 2e-5                      # fp32 (tests/test_kernels.py:28)


@pytest.fixture
def rank_of_two():
    """``world(r)``: a (1, 2) ("data", "model") mesh on which this process
    is rank r; the group is destroyed when the test ends."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def world(rank):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=2)
        return init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))

    try:
        yield world
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dtensor(t, mesh, placements):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements, run_check=False)


def randn(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        *shape).astype(np.float32))


@pytest.mark.parametrize("name", ["flash_attention", "flash_decode",
                                  "selective_scan", "mlstm"])
def test_kernel_wrappers_refuse_a_dtensor(rank_of_two, name):
    from torch.distributed.tensor import Replicate
    mesh = rank_of_two(0)

    def d(*shape):
        return dtensor(randn(*shape), mesh, [Replicate(), Replicate()])

    calls = {
        "flash_attention": lambda: ops.flash_attention(
            d(1, 2, 4, 16), d(1, 2, 4, 16), d(1, 2, 4, 16)),
        "flash_decode": lambda: ops.flash_decode(
            d(1, 2, 1, 16), d(1, 2, 4, 16), d(1, 2, 4, 16), 3),
        "selective_scan": lambda: ops.selective_scan(
            d(1, 4, 8), d(1, 4, 8), d(8, 2), d(1, 4, 2), d(1, 4, 2),
            d(1, 8, 2)),
        "mlstm": lambda: ops.mlstm(
            d(1, 4, 2, 8), d(1, 4, 2, 8), d(1, 4, 2, 8), d(1, 4, 2),
            d(1, 4, 2), d(1, 2, 8, 8)),
    }
    with pytest.raises(TypeError, match="not a DTensor"):
        calls[name]()


# (Nq, Nkv): a rank's 2 q heads are one GQA group; 3 q heads straddle two
# groups of 2 (one KV head per q head); 4 q heads are one group's block;
# no grouping.
HEADS = [(4, 2), (6, 3), (8, 2), (2, 2)]


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("nq,nkv", HEADS)
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_attention_runs_on_each_ranks_head_block(rank_of_two, rank, nq, nkv,
                                                 mode):
    from torch.distributed.tensor import Replicate, Shard
    mesh = rank_of_two(rank)
    B, hd, T = 2, 16, 12
    S = 1 if mode == "decode" else T
    q, k, v = randn(B, S, nq, hd, seed=1), randn(B, T, nkv, hd, seed=2), \
        randn(B, T, nkv, hd, seed=3)
    kw = (dict(causal=False, q_offset=7, kv_len=8) if mode == "decode"
          else dict(causal=True, window=5, cap=30.0))
    want = layers.attention(q, k, v, **kw)
    n = nq // 2
    block = slice(rank * n, (rank + 1) * n)
    got = ops.attention(
        dtensor(q[:, :, block], mesh, [Replicate(), Shard(2)]),
        dtensor(k, mesh, [Replicate(), Replicate()]),
        dtensor(v, mesh, [Replicate(), Replicate()]), **kw)
    assert tuple(got.placements) == (Replicate(), Shard(2))
    assert tuple(got.shape) == (B, S, nq, hd)
    torch.testing.assert_close(got.to_local(), want[:, :, block], rtol=TOL,
                               atol=TOL)
