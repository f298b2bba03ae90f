"""Hand-written Hopper kernels, their plain PyTorch oracles and the dispatch
that the models call (``ops``)."""
