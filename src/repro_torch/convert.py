"""Load parameters saved by the JAX package into the port's ``LM``.

The JAX parameters arrive as numpy arrays under the ``/``-joined leaf keys
that ``repro.ckpt.shards._flatten`` writes, e.g. ``embed``, ``final_ln``,
``layers/p0/mixer/wq`` and ``layers/p1/ffn/moe/w_gate``.  Leaves under
``layers/p{p}`` carry a leading dim over the pattern's periods: row ``i``
belongs to layer ``i * period + p``.  Leaves under ``rem{r}`` belong to
layer ``n_periods * period + r``.  The rest of a key is the leaf's path in
that layer's ``ParamTree``, at any depth.

This module imports no JAX: whoever holds the JAX tree flattens it.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .device import resolve
from .models.config import ModelConfig
from .models.lm import LM


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":       # ml_dtypes has no torch view
        arr = arr.astype(np.float32)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape {arr.shape} does not fit {tuple(like.shape)}")
    return torch.tensor(arr, dtype=like.dtype, device=like.device)


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
            param.copy_(_to_tensor(arr, param))
    return model
