"""The plain reference: the port's model semantics in fp32 PyTorch, one
file per layer kind, with no kernel, cache or batching of the port's.

It imports nothing of ``repro_torch`` and takes nothing the port made: it
draws each layer's weights again from the seed (``perfbench.weights``) and
works the caches and states out again by running the whole sequence.
"""
