"""Flash decode on Hopper: wrapper of the CUDA kernel in
``csrc/flash_decode.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.decode_attention.
flash_decode`` (``src/repro/kernels/decode_attention.py:66``): one query
token per (batch, head) against a preallocated ``(B,Hkv,T,hd)`` cache whose
valid prefix is the scalar ``kv_len``, at any GQA group and any head dim up
to ``MAX_HD`` (``takes``).  The kernel is bound by the K/V bytes
it streams, and at a few hundred keys by its chain of latencies: one launch
per call, the split partials merged by the last block of each (batch, KV
head, group slice) to finish.  ``plan`` picks the launch; its design notes
are in the CUDA source.

This wrapper launches the kernel or raises; it never computes on the CPU.
``repro_torch.kernels.ops`` sends CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build, refuse_grad

NAME = "flash_decode"
BLOCK_KV = 32           # keys per tile in the kernel (16 for wide fp32 rows)
STAGES = 2              # tiles in flight per block
MAX_GROUP_HD = 2048     # gs * 2 ceil(hd / 2) held in one block's registers
MAX_ROWS = 128          # query rows of one block (its 128 threads)
MAX_HD = 512
DTYPES = (torch.float32, torch.bfloat16)
TARGET_BLOCKS = 2 * 132  # two blocks for each SM of an H100
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may opt into

launches = 0        # kernel launches since the last reset (see ops)
_fn = None
# The merge's int32 ticket counters, one tensor per (device index, stream):
# a call leaves them zeroed, and calls on one stream run in stream order.
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


class Plan(NamedTuple):
    """One launch: group slices of ``group_slice`` query rows (``slices``
    of them per KV head), ``block_kv`` keys a tile, ``n_split`` splits of
    ``tiles_per_split`` tiles, ``smem`` bytes of dynamic shared memory."""
    group_slice: int
    slices: int
    block_kv: int
    n_split: int
    tiles_per_split: int
    smem: int


def takes(group: int, hd: int, dtype) -> Optional[str]:
    """None if the kernel takes a GQA group of ``group`` query heads at
    head dim ``hd`` in ``dtype``, else why not.  The one place the
    contract's limits live: ``_check`` raises with it."""
    if dtype not in DTYPES:
        return f"dtype {dtype} is not fp32 or bf16"
    if not 1 <= hd <= MAX_HD:
        return f"head_dim {hd} outside [1, MAX_HD = {MAX_HD}]"
    if group < 1:
        return f"group {group} < 1"
    return None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load(NAME).flash_decode_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int, ctypes.c_float]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def split_plan(batch: int, kv_heads: int, kv_len: int,
               block_kv: int = BLOCK_KV, slices: int = 1):
    """(n_split, tiles_per_split): split the valid KV tiles so that the grid
    of ``batch * kv_heads * slices`` blocks a split has about
    ``TARGET_BLOCKS`` blocks, every split holding at least one tile.  Each
    block's chain is one trip to memory for its (at most ``STAGES`` at the
    serving shapes) tiles, so more, shorter splits cost only the merge's
    reads of their partials."""
    n_tiles = -(-kv_len // block_kv)
    want = max(1, min(n_tiles,
                      -(-TARGET_BLOCKS // (batch * kv_heads * slices))))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def staged(hd: int, itemsize: int) -> int:
    """Elements of a staged row: hd rounded up to whole 16-byte vectors."""
    return -(-hd * itemsize // 16) * 16 // itemsize


def smem_bytes(group: int, hd: int, itemsize: int,
               block_kv: int = BLOCK_KV) -> int:
    """Dynamic shared memory of one block holding ``group`` query rows, as
    the CUDA source's ``smem_bytes`` reckons it: ``STAGES`` K and V tiles
    of ``block_kv`` keys in the input dtype, each row whole 16-byte vectors
    and 16 bytes of pad, then fp32 q, the tile's probabilities and three
    floats of row state per query row."""
    return (STAGES * 2 * block_kv * (staged(hd, itemsize) * itemsize + 16)
            + 4 * (group * staged(hd, itemsize) + group * block_kv
                   + 3 * group))


def group_slices(group: int, hd: int) -> Tuple[int, int]:
    """(rows a block, blocks a group): the group cut into the fewest slices
    whose outputs fit one block's registers (``MAX_GROUP_HD``, pairs of
    columns) and threads (``MAX_ROWS``), the rows spread evenly."""
    most = min(MAX_ROWS, MAX_GROUP_HD // (2 * -(-hd // 2)))
    slices = -(-group // most)
    return -(-group // slices), slices


def plan(batch: int, q_heads: int, kv_heads: int, hd: int, kv_len: int,
         itemsize: int) -> Plan:
    """The launch of one call: group slices, the key tile (32 keys, 16
    where two stages of 32 would not fit ``SMEM_LIMIT``) and the split."""
    gs, slices = group_slices(q_heads // kv_heads, hd)
    bk = BLOCK_KV
    if smem_bytes(gs, hd, itemsize, bk) > SMEM_LIMIT:
        bk = BLOCK_KV // 2
    n_split, per = split_plan(batch, kv_heads, kv_len, bk, slices)
    return Plan(gs, slices, bk, n_split, per,
                smem_bytes(gs, hd, itemsize, bk))


def _tickets_for(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The ticket counters of one (device, stream), at least ``n`` long."""
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def _check(q, k, v, kv_len):
    refuse_grad(NAME, q, k, v)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes must match and be fp32 or bf16: "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape[2] != 1 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, Hq, _, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Hq % Hkv:
        raise ValueError(f"q{tuple(q.shape)} does not fit k{tuple(k.shape)}")
    why = takes(Hq // Hkv, hd, q.dtype)
    if why:
        raise ValueError(why)
    if not 1 <= kv_len <= T:
        raise ValueError(f"kv_len {kv_len} outside [1, {T}]")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("last dim must be contiguous (stride 1)")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_decode kernel needs CUDA tensors; "
                         f"got {q.device}, {k.device}, {v.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def flash_decode(q, k, v, kv_len: int, *, softcap=0.0):
    """q: (B,Hq,1,hd)  k,v: (B,Hkv,T,hd)  kv_len: int -> (B,Hq,1,hd).

    Strides of the B, H and T dims are passed to the kernel, so the model
    hands in ``transpose(1, 2)`` views of its ``(B,T,Nkv,hd)`` cache.
    """
    global launches
    kv_len = int(kv_len)
    _check(q, k, v, kv_len)
    B, Hq, _, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    p = plan(B, Hq, Hkv, hd, kv_len, q.element_size())
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        part_acc = part_ml = tickets = None
        if p.n_split > 1:
            part_acc = torch.empty((B * Hq, p.n_split, 2 * -(-hd // 2)),
                                   dtype=torch.float32, device=q.device)
            part_ml = torch.empty((B * Hq, p.n_split, 2),
                                  dtype=torch.float32, device=q.device)
            tickets = _tickets_for(q.device, stream, B * Hkv * p.slices)
        err = _launcher()(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (part_acc, part_ml, tickets)),
            B, Hq, Hkv, T, hd, strides, kv_len, float(softcap),
            p.group_slice, p.slices, p.block_kv, p.n_split,
            p.tiles_per_split, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    launches += 1
    return out
