"""Parameters between the JAX package's leaf keys and the port's ``LM``.

The JAX parameters arrive as numpy arrays under the ``/``-joined leaf keys
that ``repro.ckpt.shards._flatten`` writes, e.g. ``embed``, ``final_ln``,
``layers/p0/mixer/wq`` and ``layers/p1/ffn/moe/w_gate``.  Leaves under
``layers/p{p}`` carry a leading dim over the pattern's periods: row ``i``
belongs to layer ``i * period + p``.  Leaves under ``rem{r}`` belong to
layer ``n_periods * period + r``.  The rest of a key is the leaf's path in
that layer's ``ParamTree``, at any depth.

``params_from_numpy`` loads such a flat dict into a new ``LM``;
``numpy_from_params`` goes back (``ckpt.shards`` does the same for the
whole training state, the AdamW moments included).  bf16
leaves travel as numpy's 2-byte void dtype (``V2``), the bytes that
``np.savez`` writes for the JAX package's bf16 leaves.

This module imports no JAX: whoever holds the JAX tree flattens it.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch

from .device import resolve
from .models.config import ModelConfig
from .models.lm import LM


def to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":       # ml_dtypes has no torch view
        arr = arr.astype(np.float32)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape {arr.shape} does not fit {tuple(like.shape)}")
    if arr.dtype == np.dtype("V2"):        # raw bf16 bits, as np.savez wrote
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(dtype=like.dtype,
                                            device=like.device)
    return torch.tensor(arr, dtype=like.dtype, device=like.device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host; bf16 as its raw bits in ``V2``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def jax_layout(cfg: ModelConfig, names: Iterable[str]
               ) -> Dict[str, Tuple[bool, List[str]]]:
    """JAX leaf key -> (stacked, the port parameter names it holds).  A key
    under ``layers/p{p}`` is stacked: its names are its period rows in
    order.  Keys come sorted as the JAX package flattens its dicts."""
    period = len(cfg.pattern)
    out: Dict[str, Tuple[bool, List[str]]] = {}
    for name in names:
        parts = name.split(".")
        if parts[0] != "layers":
            out[name] = (False, [name])
            continue
        li, rest = int(parts[1]), "/".join(parts[2:])
        i, p = divmod(li, period)
        if i < cfg.n_periods:
            rows = out.setdefault(f"layers/p{p}/{rest}",
                                  (True, [""] * cfg.n_periods))[1]
            rows[i] = name
        else:
            out[f"rem{li - cfg.n_periods * period}/{rest}"] = (False, [name])
    return {k: out[k] for k in sorted(out, key=lambda k: k.split("/"))}


def numpy_from_params(model: LM) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy``: the model's parameters under
    the JAX leaf keys, stacked over periods, as ``repro.ckpt.shards.
    _flatten`` gives the JAX tree."""
    params = dict(model.named_parameters())
    out = {}
    for key, (stacked, names) in jax_layout(model.cfg, params).items():
        rows = [to_numpy(params[n]) for n in names]
        out[key] = np.stack(rows) if stacked else rows[0]
    return out


def params_from_numpy(cfg: ModelConfig, flat: Mapping[str, np.ndarray], *,
                      dtype=torch.float32, device="cuda") -> LM:
    """A new ``LM`` holding the JAX parameters ``flat``; every parameter
    must be covered exactly once."""
    model = LM(cfg, dtype=dtype, device=resolve(device))
    period = len(cfg.pattern)
    targets = {}                    # flat key (+ row) -> (parameter, array)

    def leaf(key: str, li: int, path):
        node = model.layers[li]
        for name in path:
            if name not in node:
                raise KeyError(f"unknown parameter key {key!r}")
            node = node[name]
        if not isinstance(node, torch.nn.Parameter):
            raise KeyError(f"{key!r} names a subtree, not a parameter")
        return node

    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "layers":
            p = int(parts[1][1:])
            for i in range(cfg.n_periods):
                targets[f"{key}[{i}]"] = (leaf(key, i * period + p,
                                               parts[2:]),
                                          arr[i])
        elif parts[0].startswith("rem"):
            li = cfg.n_periods * period + int(parts[0][3:])
            targets[key] = (leaf(key, li, parts[1:]), arr)
        else:
            if len(parts) != 1 or not hasattr(model, key):
                raise KeyError(f"unknown parameter key {key!r}")
            targets[key] = (getattr(model, key), arr)
    seen = {id(param) for param, _ in targets.values()}
    missing = [n for n, prm in model.named_parameters() if id(prm) not in seen]
    if missing or len(seen) != len(targets):
        raise KeyError(f"parameters not covered exactly once; missing "
                       f"{missing}")
    with torch.no_grad():
        for param, arr in targets.values():
            param.copy_(to_tensor(arr, param))
    return model
