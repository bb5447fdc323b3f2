"""Observability (counterpart of ``repro.obs``).

* :mod:`repro_torch.obs.registry` -- counters / gauges / streaming
  histograms with exact order-independent snapshot merges.
* :mod:`repro_torch.obs.trace` -- span records on the event stream;
  ``tools/tracelens.py`` turns them into timelines.
* :mod:`repro_torch.obs.schema` -- the closed-world registry of event
  kinds and span names.
* :mod:`repro_torch.obs.memstat` -- planner-vs-live memory.
"""
from repro_torch.obs.memstat import MemStat
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, hist_quantile)
from repro_torch.obs.schema import EVENT_KINDS, SPAN_NAMES
from repro_torch.obs.trace import Tracer, maybe_span

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "hist_quantile",
    "Tracer", "maybe_span", "MemStat", "EVENT_KINDS", "SPAN_NAMES",
]
