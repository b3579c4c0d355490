"""PyTorch/CUDA port of the JAX package ``repro`` for one NVIDIA H100.

Module names follow the JAX package so each module's counterpart is easy to
find.  The port imports torch, numpy and the standard library only.  Its
entry points default to ``device="cuda"`` and raise when no card is present;
callers ask for the CPU explicitly (``device="cpu"``), as the tests do.
"""
