"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions
(``ref``) and the dispatch between them (``ops``).  Kernels are built at
first use (``_build``), never at import."""
