"""Continuous-batching serving on one device: slot-pooled int8 KV cache,
FCFS scheduler, the fault-tolerance layer (deadlines, cancellation,
quarantine + replay) and its metrics."""
from repro_torch.serve.cache_pool import SlotPool, scatter_request
from repro_torch.serve.engine import (ServeEngine, default_buckets,
                                      kernel_launches, supports)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.sampling import make_sampler, sample_tokens
from repro_torch.serve.scheduler import (CANCELLED, DECODE, DONE, DROPPED,
                                         FAILED, MIGRATED, PREFILL, QUEUED,
                                         TERMINAL, AdmissionRejected, Request,
                                         Scheduler)
from repro_torch.serve.trace import TraceRequest, synthetic_trace

__all__ = [
    "ServeEngine", "SlotPool", "Scheduler", "Request", "ServeMetrics",
    "TraceRequest", "synthetic_trace", "scatter_request", "sample_tokens",
    "make_sampler", "default_buckets", "supports", "kernel_launches",
    "AdmissionRejected",
    "QUEUED", "PREFILL", "DECODE", "DONE",
    "CANCELLED", "DROPPED", "FAILED", "MIGRATED", "TERMINAL",
]
