"""Synthetic data (counterpart of ``repro.data``)."""
