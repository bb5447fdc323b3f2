"""int8 KV cache: quantization and split-K decode (CUDA kernel + plain)."""
