"""Observability: the bounded-memory metrics registry."""
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, hist_quantile)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "hist_quantile"]
