"""Shard (de)serialization: the training state's leaves ↔ bytes, and host
partitioning (port of ``repro.ckpt.shards``).

Format: npz of path-keyed arrays, the JAX package's: the keys are its leaf
keys (``params/embed``, ``params/layers/p0/mixer/wq``, ``opt/m/...``,
``params/rem0/...``), and a leaf under ``layers/p{p}`` is stacked over the
pattern's periods (row ``i`` is layer ``i * period + p``), so either
package restores an epoch the other wrote.  bf16 leaves are written as
2-byte void (``V2``) holding the bf16 bits, which is what ``np.savez`` makes
of the JAX package's bf16 leaves.  ``partition_leaves`` deterministically
assigns leaf paths to hosts by a size-balanced greedy rule, so a restore
can reassemble the full state from any historical host count — this is
what makes restarts *elastic*.

A state tree is a nested dict whose leaves are an ``LM`` or mappings keyed
by its parameter names (the AdamW moments); every such mapping takes the
``LM``'s layout:  ``{"params": model, "opt": {"m": m, "v": v}}``.

Also home to the k-of-n erasure codec (``ec_encode`` / ``ec_decode``),
copied from the JAX package: a Reed-Solomon-lite code over GF(256) with a
Vandermonde generator matrix, numpy-only.  A checkpoint payload split into
``k`` data stripes becomes ``n`` fragments — one per replica volume — any
``k`` of which reconstruct the payload.  Fragments carry a self-describing
header (k, n, index, payload length), so a restore can decode from
whatever subset survived without any out-of-band metadata.
"""
from __future__ import annotations

import io
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import jax_layout, to_numpy, to_tensor
from ..models.lm import LM


def _find_model(tree) -> Optional[LM]:
    if isinstance(tree, LM):
        return tree
    for node in tree.values():
        if isinstance(node, (LM, dict)):
            found = _find_model(node)
            if found is not None:
                return found
    return None


def _leaves(tree) -> Dict[str, Tuple[bool, List[torch.Tensor]]]:
    """Flat key -> (stacked over periods, the tensors it holds), in the JAX
    package's flattening order (dict keys sorted at every level)."""
    model = _find_model(tree)
    if model is None:
        raise ValueError("the state tree holds no LM to take the layout of")
    out: Dict[str, Tuple[bool, List[torch.Tensor]]] = {}

    def walk(node, prefix):
        if isinstance(node, nn.Module):
            node = dict(node.named_parameters())
        if all(isinstance(v, torch.Tensor) for v in node.values()):
            for k, (stacked, names) in jax_layout(model.cfg, node).items():
                out[prefix + k] = (stacked, [node[n] for n in names])
            return
        for k in sorted(node):
            walk(node[k], f"{prefix}{k}/")

    walk(tree, "")
    return out


def _flatten(tree, keys: Optional[Iterable[str]] = None
             ) -> Dict[str, np.ndarray]:
    """The state's leaves as numpy under the JAX leaf keys; only ``keys``
    when given (a host packs its own leaves without copying the rest off
    the card)."""
    leaves = _leaves(tree)
    flat = {}
    for key in (leaves if keys is None else keys):
        stacked, tensors = leaves[key]
        rows = [to_numpy(t) for t in tensors]
        flat[key] = np.stack(rows) if stacked else rows[0]
    return flat


def pack_tree(tree, keys: Sequence[str] | None = None) -> bytes:
    """Serialize (a subset of) the state's leaves."""
    flat = _flatten(tree, keys)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def unpack_tree(payload: bytes) -> Dict[str, np.ndarray]:
    buf = io.BytesIO(payload)
    with np.load(buf) as z:
        return {k: z[k] for k in z.files}


@torch.no_grad()
def merge_into_tree(tree, flat: Dict[str, np.ndarray]):
    """Load flat path->array entries into the state's tensors in place (the
    ``LM``'s parameters and the moments); keys the state lacks are ignored,
    as the reference's template merge ignores them.  Returns ``tree``."""
    leaves = _leaves(tree)
    for key, arr in flat.items():
        if key not in leaves:
            continue
        stacked, tensors = leaves[key]
        rows = list(arr) if stacked else [arr]
        if len(rows) != len(tensors):
            raise ValueError(f"{key}: {len(rows)} rows for {len(tensors)} "
                             f"layers")
        for t, row in zip(tensors, rows):
            t.copy_(to_tensor(row, t))
    return tree


def partition_leaves(tree, n_hosts: int) -> List[List[str]]:
    """Deterministic size-balanced assignment of leaf paths to hosts."""
    sizes = {key: sum(t.numel() * t.element_size() for t in tensors)
             for key, (_, tensors) in _leaves(tree).items()}
    items = sorted(sizes.items(), key=lambda kv: (-kv[1], kv[0]))
    buckets: List[List[str]] = [[] for _ in range(n_hosts)]
    loads = [0] * n_hosts
    for key, nbytes in items:
        i = loads.index(min(loads))
        buckets[i].append(key)
        loads[i] += max(1, nbytes)
    return buckets


# ---------------------------------------------------------------------------
# k-of-n erasure codec (Reed-Solomon-lite over GF(256), numpy-only)
# ---------------------------------------------------------------------------
# GF(2^8) with the AES reduction polynomial 0x11d; exp table doubled so a
# log-sum (max 508) indexes without a mod.
_GF_EXP = np.zeros(512, dtype=np.uint8)
_GF_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _GF_EXP[_i] = _x
    _GF_LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
_GF_EXP[255:510] = _GF_EXP[:255]

# Full 256x256 product table: _GF_MUL[c] maps a byte vector through "*c"
# with one fancy-index — the whole codec is table lookups and XORs.
_GF_MUL = np.zeros((256, 256), dtype=np.uint8)
_nz = np.arange(1, 256)
for _c in range(1, 256):
    _GF_MUL[_c, 1:] = _GF_EXP[_GF_LOG[_c] + _GF_LOG[_nz]]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_GF_EXP[_GF_LOG[a] + _GF_LOG[b]])


def _gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    return int(_GF_EXP[255 - _GF_LOG[a]])


# Fragment header: magic, k, n, fragment index, original payload length.
_EC_HEADER = struct.Struct(">4sBBBQ")
_EC_MAGIC = b"ECS1"


def ec_encode(payload: bytes, k: int, n: int) -> List[bytes]:
    """Encode ``payload`` into ``n`` fragments, any ``k`` of which decode.

    Fragment j is the GF(256) inner product of the k data stripes with the
    Vandermonde row (x_j^0 .. x_j^{k-1}), x_j = j+1: distinct nonzero
    evaluation points, so every k×k row subset is invertible.
    """
    if not 1 <= k <= n <= 255:
        raise ValueError(f"need 1 <= k <= n <= 255, got k={k} n={n}")
    data = np.frombuffer(payload, dtype=np.uint8)
    stripe = max(1, -(-len(data) // k))
    padded = np.zeros(k * stripe, dtype=np.uint8)
    padded[:len(data)] = data
    stripes = padded.reshape(k, stripe)
    frags: List[bytes] = []
    for j in range(n):
        x = j + 1
        acc = np.zeros(stripe, dtype=np.uint8)
        coeff = 1
        for i in range(k):
            acc ^= _GF_MUL[coeff][stripes[i]]
            coeff = _gf_mul(coeff, x)
        frags.append(_EC_HEADER.pack(_EC_MAGIC, k, n, j, len(payload))
                     + acc.tobytes())
    return frags


def ec_decode(fragments: Sequence[bytes]) -> bytes:
    """Reconstruct the payload from any >= k surviving fragments.

    Headers are self-describing; duplicates and fragments from a different
    (k, n) geometry are rejected.  Raises ``ValueError`` when fewer than k
    distinct fragments survive — the caller's signal that the epoch's data
    really is gone.
    """
    seen: Dict[int, np.ndarray] = {}
    geometry = None
    for frag in fragments:
        if len(frag) < _EC_HEADER.size:
            raise ValueError("truncated erasure fragment")
        magic, k, n, j, orig_len = _EC_HEADER.unpack(
            frag[:_EC_HEADER.size])
        if magic != _EC_MAGIC:
            raise ValueError(f"bad fragment magic {magic!r}")
        if geometry is None:
            geometry = (k, n, orig_len)
        elif geometry != (k, n, orig_len):
            raise ValueError(f"mixed fragment geometries: {geometry} "
                             f"vs {(k, n, orig_len)}")
        seen.setdefault(j, np.frombuffer(frag[_EC_HEADER.size:],
                                         dtype=np.uint8))
    if geometry is None:
        raise ValueError("no fragments")
    k, n, orig_len = geometry
    if len(seen) < k:
        raise ValueError(f"need {k} distinct fragments, "
                         f"have {len(seen)} of {n}")
    rows = sorted(seen.items())[:k]
    # Solve A·D = F by Gauss-Jordan over GF(256); row ops on the fragment
    # byte vectors ride the product table.
    A = [[pow_gf(j + 1, i) for i in range(k)] for j, _ in rows]
    F = np.stack([body.copy() for _, body in rows])
    for col in range(k):
        pivot = next(r for r in range(col, k) if A[r][col] != 0)
        A[col], A[pivot] = A[pivot], A[col]
        F[[col, pivot]] = F[[pivot, col]]
        inv = _gf_inv(A[col][col])
        A[col] = [_gf_mul(inv, v) for v in A[col]]
        F[col] = _GF_MUL[inv][F[col]]
        for r in range(k):
            f = A[r][col]
            if r == col or f == 0:
                continue
            A[r] = [a ^ _gf_mul(f, b) for a, b in zip(A[r], A[col])]
            F[r] ^= _GF_MUL[f][F[col]]
    return F.reshape(-1).tobytes()[:orig_len]


def pow_gf(x: int, e: int) -> int:
    """x**e in GF(256) (e >= 0)."""
    out = 1
    for _ in range(e):
        out = _gf_mul(out, x)
    return out
