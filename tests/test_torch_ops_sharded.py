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
* The scans' DTensor entries run on each rank's local shards:
  ``ops.selective_scan_on_shards`` on a block of the channels (u, dt, a
  and the state cut on di, b and c whole) or of the batch, and
  ``ops.mlstm_on_shards`` on a block of the batch; each rank's y and final
  state are its block of the whole scan's, through the kernel wrapper's
  CPU branch and through the model's plain scan, and a DTensor cache
  handed as ``out`` is the state returned, written on the rank's shard.

Each case runs as rank r of a fake process group of two (the "fake"
backend of ``torch.testing``: no other rank exists and no collective
moves data), which the test destroys.  The placements given match the
ones the call keeps, so the local-shard path issues no collective.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import blocks, layers  # noqa: E402

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


def _block(t, dim, rank, parts=2):
    n = t.shape[dim] // parts
    return t.narrow(dim, rank * n, n).contiguous()


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("cut", ["channels", "batch"])
@pytest.mark.parametrize("scan", ["wrapper", "plain"])
def test_selective_scan_runs_on_each_ranks_block(rank_of_two, rank, cut,
                                                 scan):
    from torch.distributed.tensor import Replicate, Shard
    mesh = rank_of_two(rank)
    B, S, di, N = 2, 12, 8, 4
    u = randn(B, S, di, seed=1)
    dt = torch.nn.functional.softplus(randn(B, S, di, seed=2))
    a = -torch.exp(randn(di, N, seed=3))
    b, c = randn(B, S, N, seed=4), randn(B, S, N, seed=5)
    h0 = randn(B, di, N, seed=6)
    want_y, want_h = ref.mamba_scan_ref(u, dt, a, b, c, h0)
    R = Replicate()
    if cut == "channels":     # u, dt, a and the state cut on di
        pl = {"u": Shard(2), "a": Shard(0), "b": R, "h": Shard(1)}
        local = {"u": _block(u, 2, rank), "dt": _block(dt, 2, rank),
                 "a": _block(a, 0, rank), "b": b, "c": c,
                 "h": _block(h0, 1, rank)}
        want_y, want_h = _block(want_y, 2, rank), _block(want_h, 1, rank)
    else:                     # every tensor but a cut on the batch
        pl = {"u": Shard(0), "a": R, "b": Shard(0), "h": Shard(0)}
        local = {"u": _block(u, 0, rank), "dt": _block(dt, 0, rank), "a": a,
                 "b": _block(b, 0, rank), "c": _block(c, 0, rank),
                 "h": _block(h0, 0, rank)}
        want_y, want_h = _block(want_y, 0, rank), _block(want_h, 0, rank)

    def d(name, key=None):
        return dtensor(local[name], mesh, [R, pl[key or name]])

    args = (d("u"), d("dt", "u"), d("a"), d("b"), d("c", "b"), d("h"))
    if scan == "wrapper":
        out = dtensor(torch.zeros_like(local["h"]), mesh, [R, pl["h"]])
        y, h = ops.selective_scan_on_shards(ops.selective_scan, *args,
                                            out=out)
        assert h is out
    else:
        y, h = ops.selective_scan_on_shards(blocks._ssm_scan, *args)
    assert tuple(y.shape) == (B, S, di) and tuple(h.shape) == (B, di, N)
    assert tuple(y.placements) == (R, pl["u"])
    assert tuple(h.placements) == (R, pl["h"])
    torch.testing.assert_close(y.to_local(), want_y, rtol=TOL, atol=TOL)
    torch.testing.assert_close(h.to_local(), want_h, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("cut", ["batch", "none"])
@pytest.mark.parametrize("cell", ["wrapper", "plain"])
def test_mlstm_runs_on_each_ranks_batch_block(rank_of_two, rank, cut, cell):
    from torch.distributed.tensor import Replicate, Shard
    mesh = rank_of_two(rank)
    B, S, H, hd = 2, 12, 2, 8
    q, k, v = (randn(B, S, H, hd, seed=s) for s in (1, 2, 3))
    i_gate, f_gate = (torch.sigmoid(randn(B, S, H, seed=s)) for s in (4, 5))
    c0, n0 = randn(B, H, hd, hd, seed=6), randn(B, H, hd, seed=7)
    want = ref.mlstm_ref(q, k, v, i_gate, f_gate, c0, n0)
    pl = [Replicate(), Shard(0) if cut == "batch" else Replicate()]
    ts = (q, k, v, i_gate, f_gate, c0, n0)
    if cut == "batch":
        ts = tuple(_block(t, 0, rank) for t in ts)
        want = tuple(_block(t, 0, rank) for t in want)
    args = [dtensor(t, mesh, pl) for t in ts]
    if cell == "wrapper":
        out, n_out = (dtensor(torch.zeros_like(t), mesh, pl)
                      for t in ts[5:])
        y, c_last, n_last = ops.mlstm_on_shards(ops.mlstm, *args, out=out,
                                                n_out=n_out)
        assert c_last is out and n_last is n_out
    else:
        y, c_last, n_last = ops.mlstm_on_shards(blocks._mlstm_cell, *args)
    for got, shape, w in zip((y, c_last, n_last),
                             ((B, S, H, hd), (B, H, hd, hd), (B, H, hd)),
                             want):
        assert tuple(got.shape) == shape and list(got.placements) == pl
        torch.testing.assert_close(got.to_local(), w, rtol=TOL, atol=TOL)
