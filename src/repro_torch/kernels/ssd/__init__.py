"""Mamba2 SSD chunk scan: CUDA kernel + plain version."""
