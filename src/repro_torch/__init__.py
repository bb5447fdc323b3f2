"""PyTorch port of ``repro`` for NVIDIA Hopper (see ROADMAP.md).

Same subpackage layout and function names as the JAX package, which stays
the reference; the port never imports it or JAX.  Importing this package
imports nothing but its own modules: CUDA kernels are built and loaded on
their first launch.
"""
