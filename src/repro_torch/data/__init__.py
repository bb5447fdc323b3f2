"""Synthetic data and the E-D loader (counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import LoaderState, ParallelEncodedLoader
from repro_torch.data.synthetic import make_cifar_like, token_stream

__all__ = ["LoaderState", "ParallelEncodedLoader", "make_cifar_like",
           "token_stream"]
