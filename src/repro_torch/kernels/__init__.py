"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions
(``ref``) and the dispatch between them (``ops``).  Kernels are built at
first use (``_build``), never at import."""
import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``ValueError`` when autograd would record through a kernel.

    A wrapper fills outputs that it allocated through ``ctypes``, so they
    carry no ``grad_fn``: a backward would drop every gradient below the
    call and raise nothing.  Gradients come from the plain path
    (``Ctx.plain``), as the JAX package differentiates ``layers.attention``
    and the plain scans and has no backward kernel.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise ValueError(
            f"{name} kernel has no backward: an input requires grad while "
            f"grad is enabled (take the plain path, Ctx.plain, to train, or "
            f"call it under torch.no_grad() / torch.inference_mode())")
