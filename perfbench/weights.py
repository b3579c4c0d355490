"""Parameters drawn from the run's seed, one leaf at a time by its name.

Each leaf has its own ``torch.Generator`` on the device, seeded from
(seed, leaf name), so any leaf can be drawn again alone: the harness draws
every leaf once into the port's model, and the reference draws one layer's
leaves again when it reaches that layer.  A leaf is drawn whole, in the
dtype it is served in, in one call on the device; the same call on the
same device gives the same bits.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class Param:
    """One leaf: its shape and its draw.  ``normal``: mean + std * N(0, 1);
    ``log_uniform``: log of a value drawn log-uniformly in [lo, hi]
    (mamba's A = -exp(a_log) then spans [-hi, -lo])."""
    shape: Tuple[int, ...]
    init: str = "normal"
    std: float = 0.0
    mean: float = 0.0
    lo: float = 1.0
    hi: float = 1.0


def key(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def draw(p: Param, seed: int, name: str, dtype, device) -> torch.Tensor:
    """The leaf ``name`` of the model drawn from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(key(seed, name))
    if p.init == "normal":
        t = torch.randn(p.shape, generator=gen, dtype=dtype, device=device)
        t.mul_(p.std)
        return t.add_(p.mean) if p.mean else t
    if p.init == "log_uniform":
        u = torch.rand(p.shape, generator=gen, dtype=torch.float32,
                       device=device)
        lo, hi = torch.tensor(p.lo).log(), torch.tensor(p.hi).log()
        return (lo + u * (hi - lo)).to(dtype)
    raise ValueError(f"unknown draw {p.init!r} for {name}")


def fill(params: Dict[str, torch.nn.Parameter], schema: Dict[str, Param],
         seed: int) -> None:
    """Draw every leaf of ``schema`` into the tensors ``params`` of the
    same names, in their dtype and on their device.  The two must name
    the same leaves with the same shapes."""
    have = {n: tuple(p.shape) for n, p in params.items()}
    want = {n: tuple(p.shape) for n, p in schema.items()}
    if have != want:
        missing = sorted(set(want) - set(have))
        extra = sorted(set(have) - set(want))
        wrong = sorted(n for n in set(have) & set(want)
                       if have[n] != want[n])
        raise ValueError(f"the model's leaves differ from the schema: "
                         f"missing {missing[:5]}, extra {extra[:5]}, "
                         f"shapes {[(n, have[n], want[n]) for n in wrong[:5]]}")
    with torch.no_grad():
        for name, t in params.items():
            t.copy_(draw(schema[name], seed, name, t.dtype, t.device))
