"""Serving observability: TTFT, inter-token latency, throughput, goodput,
queue depth, slot occupancy, and failure-path counters.

Latencies are wall-clock (``time.perf_counter``); scheduling quantities
(queue depth, occupancy) are sampled once per engine step, so their means
are per-step averages.  TTFT for a request counts from the moment the
engine first SEES it (submit) to its first sampled token — queueing delay
included, which is the honest serving number.

Throughput vs goodput: ``total_tokens``/``tokens_per_s`` count every
emitted token, including tokens from requests that were later cancelled,
dropped, or failed; ``goodput_tokens``/``goodput_tokens_per_s`` count
only tokens of requests that reached ``DONE`` — the number a client
actually got value from.  Under faults the gap between the two is the
cost of the failure paths.

Metric state is **O(live), not O(history)** (ISSUE 10): per-request
stats exist only while the request is in flight; at terminal time they
retire into a :class:`repro_torch.obs.MetricsRegistry` — counters plus
bounded-memory streaming histograms — so a router that serves millions
of requests holds a fixed-size ledger.  Means stay exact (histograms
carry exact n/sum); ``ttft_p50_s``/``ttft_p95_s`` are streaming
log2-bucket quantiles.  The registry snapshot also crosses the worker
RPC boundary and merges fleet-wide (see ``serve/worker.py``).

With a ``sink`` (any object with ``emit(kind, **fields)``) the failure-path counters
also stream to the append-only JSONL log as they happen — the long-run
metrics record PR 7 left open.  ``fleet_summary`` is the replica
aggregation the router uses: per-replica summaries roll up into fleet
goodput/throughput plus the failover-specific counters.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serve.scheduler import CANCELLED, DONE, DROPPED, FAILED, MIGRATED


@dataclasses.dataclass
class _ReqStats:
    t_submit: float
    submit_step: int
    t_first: Optional[float] = None
    first_step: Optional[int] = None
    t_last: Optional[float] = None
    n_tokens: int = 0
    itl_sum: float = 0.0
    itl_n: int = 0
    retries: int = 0
    faults: int = 0


def _mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else 0.0


_TERMINALS = (DONE, CANCELLED, DROPPED, FAILED, MIGRATED)


class ServeMetrics:
    """Per-request latency accounting + per-step gauges + fault counters.

    Live requests keep a small :class:`_ReqStats`; everything else lives
    in ``self.registry``.  The legacy counter attributes (``rejected``,
    ``faults``, ``retries``, ``tokens_emitted``) are read-only views of
    the registry so existing callers (the router's breaker, the stall
    detector, the tests) keep working unchanged.
    """

    def __init__(self, clock=time.perf_counter, *, sink=None,
                 replica: Optional[int] = None, registry=None):
        self._clock = clock
        self._live: dict[int, _ReqStats] = {}
        self._t0: Optional[float] = None
        self._t_end: Optional[float] = None
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.sink = sink                   # optional EventSink (JSONL)
        self.replica = replica             # fleet: which replica emits

    # legacy counters, now registry-backed ---------------------------------
    @property
    def rejected(self) -> int:             # bounded-queue backpressure
        return self.registry.count("serve.rejected")

    @property
    def faults(self) -> int:               # decode sentinel trips
        return self.registry.count("serve.faults")

    @property
    def retries(self) -> int:              # replays scheduled
        return self.registry.count("serve.retries")

    @property
    def tokens_emitted(self) -> int:       # running total (stall detector)
        return self.registry.count("serve.tokens")

    def _event(self, kind: str, **fields) -> None:
        if self.sink is not None:
            if self.replica is not None:
                fields["replica"] = self.replica
            self.sink.emit(kind, **fields)

    def now(self) -> float:
        return self._clock()

    # -- request lifecycle -------------------------------------------------
    def on_submit(self, rid: int, step: int) -> None:
        t = self.now()
        if self._t0 is None:
            self._t0 = t
        self._live[rid] = _ReqStats(t_submit=t, submit_step=step)
        self.registry.inc("serve.submitted")

    def on_token(self, rid: int, step: int) -> None:
        r = self._live[rid]
        t = self.now()
        if r.t_first is None:
            r.t_first, r.first_step = t, step
        elif r.t_last is not None:
            r.itl_sum += t - r.t_last
            r.itl_n += 1
        r.t_last = t
        r.n_tokens += 1
        self.registry.inc("serve.tokens")
        self._t_end = t

    def _retire(self, rid: int, state: str) -> _ReqStats:
        """Fold a finished request's stats into the registry and free it."""
        r = self._live.pop(rid)
        reg = self.registry
        reg.inc(f"serve.terminal.{state}")
        if state == DONE:
            reg.inc("serve.goodput_tokens", r.n_tokens)
            if r.t_first is not None:
                reg.observe("serve.ttft_s", r.t_first - r.t_submit)
            if r.first_step is not None:
                reg.observe("serve.ttft_steps", r.first_step - r.submit_step)
            if r.itl_n:
                reg.observe("serve.itl_s", r.itl_sum / r.itl_n)
        # a request migrated off this replica is judged at FLEET level —
        # it must not count against the local replay success rate
        if r.retries and state != MIGRATED:
            reg.inc("serve.retired_retried")
            if state == DONE:
                reg.inc("serve.retired_retried_done")
        return r

    def on_done(self, rid: int) -> None:
        self._t_end = self.now()
        self._retire(rid, DONE)

    def on_terminal(self, rid: int, state: str) -> None:
        """A request left the system without finishing (CANCELLED /
        DROPPED / FAILED / MIGRATED)."""
        r = self._retire(rid, state)
        self._event("terminal", rid=rid, state=state, tokens=r.n_tokens)

    def on_reject(self) -> None:
        self.registry.inc("serve.rejected")
        self._event("reject")

    def on_fault(self, rid: int) -> None:
        self.registry.inc("serve.faults")
        self._live[rid].faults += 1
        self._event("fault", rid=rid)

    def on_retry(self, rid: int) -> None:
        self.registry.inc("serve.retries")
        self._live[rid].retries += 1
        self._event("retry", rid=rid, attempt=self._live[rid].retries)

    # -- per-step gauges ---------------------------------------------------
    def on_step(self, step: int, queue_depth: int, occupancy: int) -> None:
        self.registry.inc("serve.steps")
        self.registry.observe("serve.queue_depth", queue_depth)
        self.registry.observe("serve.occupancy", occupancy)

    def registry_snapshot(self) -> dict:
        return self.registry.snapshot()

    # -- aggregation -------------------------------------------------------
    def summary(self, *, max_slots: int = 0) -> dict:
        reg = self.registry
        count = reg.count
        n_done = count(f"serve.terminal.{DONE}")
        total_tokens = count("serve.tokens")
        goodput_tokens = count("serve.goodput_tokens")
        wall = ((self._t_end - self._t0)
                if self._t0 is not None and self._t_end is not None else 0.0)
        ttft = reg.histogram("serve.ttft_s")
        ttft_steps = reg.histogram("serve.ttft_steps")
        itl = reg.histogram("serve.itl_s")
        qd = reg.histogram("serve.queue_depth")
        occ = reg.histogram("serve.occupancy")
        # of the requests that needed at least one replay, how many still
        # finished — the replay path's success rate.  Still-live retried
        # requests count in the denominator (they haven't succeeded yet).
        n_retried_judged = count("serve.retired_retried") + \
            sum(1 for r in self._live.values() if r.retries)
        out = {
            "n_requests": count("serve.submitted"),
            "n_done": n_done,
            "n_cancelled": count(f"serve.terminal.{CANCELLED}"),
            "n_dropped": count(f"serve.terminal.{DROPPED}"),
            "n_failed": count(f"serve.terminal.{FAILED}"),
            "n_migrated_out": count(f"serve.terminal.{MIGRATED}"),
            "n_rejected": self.rejected,
            "n_faults": self.faults,
            "n_retried": self.retries,
            "retry_success_rate": (
                count("serve.retired_retried_done") / n_retried_judged
                if n_retried_judged else 1.0),
            "total_tokens": total_tokens,
            "goodput_tokens": goodput_tokens,
            "wall_s": wall,
            "tokens_per_s": total_tokens / wall if wall > 0 else 0.0,
            "goodput_tokens_per_s": (goodput_tokens / wall
                                     if wall > 0 else 0.0),
            "ttft_mean_s": ttft.mean,
            "ttft_p50_s": ttft.quantile(0.5),
            "ttft_p95_s": ttft.quantile(0.95),
            "ttft_mean_steps": ttft_steps.mean,
            "itl_mean_s": itl.mean,
            "queue_depth_mean": qd.mean,
            "queue_depth_max": int(qd.max) if qd.n else 0,
            "occupancy_mean": occ.mean,
            "occupancy_max": int(occ.max) if occ.n else 0,
            "n_steps": count("serve.steps"),
        }
        if max_slots:
            out["occupancy_frac"] = out["occupancy_mean"] / max_slots
        return out


def fleet_summary(replica_summaries: Sequence[dict]) -> dict:
    """Aggregate per-replica :meth:`ServeMetrics.summary` dicts into the
    fleet view the router builds on.

    Counts SUM (each locally-terminal request is terminal on exactly one
    replica; a migrated request is ``n_migrated_out`` on its source and
    live or terminal on its target, so fleet-level dedup happens in the
    router's own request table — this helper only rolls up the replica
    ledgers).  Rates re-derive from the summed tokens and the widest
    wall-clock span rather than averaging averages."""
    keys_sum = ("n_requests", "n_done", "n_cancelled", "n_dropped",
                "n_failed", "n_migrated_out", "n_rejected", "n_faults",
                "n_retried", "total_tokens", "goodput_tokens", "n_steps")
    out = {k: sum(s.get(k, 0) for s in replica_summaries) for k in keys_sum}
    wall = max((s.get("wall_s", 0.0) for s in replica_summaries),
               default=0.0)
    out["wall_s"] = wall
    out["tokens_per_s"] = out["total_tokens"] / wall if wall > 0 else 0.0
    out["goodput_tokens_per_s"] = (out["goodput_tokens"] / wall
                                   if wall > 0 else 0.0)
    out["per_replica"] = list(replica_summaries)
    return out
