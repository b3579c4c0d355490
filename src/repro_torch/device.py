"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is present.

    The entry points default to ``"cuda"``; a machine without a card gets an
    error rather than a silent run on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:       # "cuda" means the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
