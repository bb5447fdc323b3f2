"""The E-D codec's decode and encode (CUDA kernels + plain versions)."""
