"""Continuous-batching serving (counterpart of ``repro.serve``): slot-pooled
int8 KV cache, FCFS scheduler, the fault-tolerance layer (deadlines,
cancellation, quarantine + replay), the replica fleet (router,
health-based failover, cross-replica migration), and the durable serving
plane (write-ahead request journal, subprocess replica workers,
whole-fleet crash recovery)."""
from repro_torch.serve.cache_pool import SlotPool, scatter_request
from repro_torch.serve.engine import (ServeEngine, default_buckets,
                                      kernel_launches, supports)
from repro_torch.serve.faults import (FaultEvent, FaultInjector, FaultPlan,
                                      FleetFaultInjector, SimulatedCrash,
                                      chaos_plan, crash_after_appends,
                                      poison_slot, tear_tail)
from repro_torch.serve.journal import (WAL_KINDS, JournalState,
                                       RequestJournal, load_state)
from repro_torch.serve.metrics import ServeMetrics, fleet_summary
from repro_torch.serve.router import (ACCEPTING, DEAD, DEGRADED, DRAINED,
                                      DRAINING, HEALTHY, QUARANTINED,
                                      BreakerConfig, FleetRequest, Router,
                                      make_fleet)
from repro_torch.serve.sampling import (fold_request_key, make_sampler,
                                        sample_tokens, sample_tokens_per_row)
from repro_torch.serve.scheduler import (CANCELLED, DECODE, DONE, DROPPED,
                                         FAILED, MIGRATED, PREFILL, QUEUED,
                                         TERMINAL, AdmissionRejected, Request,
                                         Scheduler)
from repro_torch.serve.trace import TraceRequest, synthetic_trace
from repro_torch.serve.worker import (WorkerDied, WorkerProxy,
                                      engine_factory, spawn_worker,
                                      spawn_workers)

__all__ = [
    "ServeEngine", "SlotPool", "Scheduler", "Request", "ServeMetrics",
    "TraceRequest", "synthetic_trace", "scatter_request", "sample_tokens",
    "sample_tokens_per_row", "fold_request_key",
    "make_sampler", "default_buckets", "supports", "kernel_launches",
    "FaultPlan", "FaultEvent", "FaultInjector", "FleetFaultInjector",
    "chaos_plan", "poison_slot", "AdmissionRejected",
    "SimulatedCrash", "crash_after_appends", "tear_tail",
    "RequestJournal", "JournalState", "load_state", "WAL_KINDS",
    "WorkerProxy", "WorkerDied", "spawn_worker", "spawn_workers",
    "engine_factory",
    "Router", "BreakerConfig", "FleetRequest", "make_fleet",
    "fleet_summary",
    "HEALTHY", "DEGRADED", "QUARANTINED", "DRAINING", "DRAINED", "DEAD",
    "ACCEPTING",
    "QUEUED", "PREFILL", "DECODE", "DONE",
    "CANCELLED", "DROPPED", "FAILED", "MIGRATED", "TERMINAL",
]
