"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the tile arithmetic both share."""
