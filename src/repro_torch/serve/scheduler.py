"""Request lifecycle + FCFS admission under a slot/byte budget.

The full state machine (ISSUE 7 added the failure half):

    QUEUED -> PREFILL -> DECODE -> DONE
      |  \\                  |  \\
      |   +-> DROPPED       |   +-> CANCELLED
      +-> CANCELLED         +-> FAILED
                            |
                            +-> QUEUED   (replay after a detected fault)

``DONE``/``CANCELLED``/``DROPPED``/``FAILED`` are terminal.  Admission is
first-come-first-served: a queued request joins only when (a) a pool
slot is free, (b) the byte budget admits one more resident slot, and
(c) the per-step prefill quota has room — the quota is the
prefill-vs-decode interleave knob: prefills are the expensive joins, so
capping them per engine step bounds the inter-token latency the resident
decodes pay while new requests stream in.

Overload is handled explicitly instead of queueing forever:

* a bounded queue (``max_queue``) rejects submits with
  :class:`AdmissionRejected` — backpressure the caller can see;
* per-request deadlines (``deadline_steps``, a queue TTL in engine
  steps) shed expired queued requests to ``DROPPED`` — load shedding;
* ``cancel_queued`` / ``retire(state=CANCELLED)`` support caller-side
  cancellation, and ``requeue`` puts a faulted resident request back at
  the HEAD of the line for deterministic replay (it already waited its
  turn; the backoff rides its new ``arrival_step``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

QUEUED, PREFILL, DECODE, DONE = "QUEUED", "PREFILL", "DECODE", "DONE"
CANCELLED, DROPPED, FAILED = "CANCELLED", "DROPPED", "FAILED"
#: the request left THIS engine for another replica (fleet router); it
#: is terminal locally — the fleet-level request lives on elsewhere
MIGRATED = "MIGRATED"
#: states a request can never leave
TERMINAL = frozenset({DONE, CANCELLED, DROPPED, FAILED, MIGRATED})


class AdmissionRejected(RuntimeError):
    """Bounded-queue backpressure: the scheduler refused a submit."""


@dataclasses.dataclass
class Request:
    """One generation request moving through the engine."""
    rid: int
    prompt: np.ndarray                    # (prompt_len,) int32
    max_new_tokens: int
    arrival_step: int = 0                 # engine step at which it exists
    eos_id: Optional[int] = None          # per-request EOS override
    deadline_steps: Optional[int] = None  # queue TTL in engine steps
    # sampler-key identity: the PRNG stream this request draws from in
    # the engine's "request" key mode.  The fleet router passes the
    # GLOBAL request id here so a migrated request keeps sampling the
    # same trajectory on any replica; None falls back to the local rid.
    key_id: Optional[int] = None
    # -- engine-owned state -----------------------------------------------
    state: str = QUEUED
    slot: Optional[int] = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    retries: int = 0                      # replay attempts consumed
    fail_reason: Optional[str] = None     # set on FAILED
    # open span ids by name ("req"/"queue"/"decode") when tracing is on
    span_ids: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError(f"Request {self.rid}: prompt must be a "
                             f"non-empty 1-D token array")
        if self.max_new_tokens < 1:
            raise ValueError(f"Request {self.rid}: max_new_tokens must be "
                             f">= 1, got {self.max_new_tokens}")
        if self.deadline_steps is not None and self.deadline_steps < 0:
            raise ValueError(f"Request {self.rid}: deadline_steps must be "
                             f">= 0, got {self.deadline_steps}")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def total_len(self) -> int:
        """Worst-case resident length (prompt + full generation)."""
        return self.prompt_len + self.max_new_tokens


class Scheduler:
    """FCFS queue with slot/byte-budget admission and explicit overload.

    ``byte_budget``/``bytes_per_slot`` bound resident slots by memory (the
    planner's ``serve_capacity_report`` derives the same number ahead of
    time); ``max_prefill_per_step`` is the interleave quota;
    ``max_queue`` bounds the queue (None = unbounded, the pre-ISSUE-7
    behavior).
    """

    def __init__(self, max_slots: int, *, bytes_per_slot: int = 0,
                 byte_budget: Optional[int] = None,
                 max_prefill_per_step: int = 1,
                 max_queue: Optional[int] = None):
        if max_prefill_per_step < 1:
            raise ValueError("Scheduler: max_prefill_per_step must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("Scheduler: max_queue must be >= 1 (or None)")
        self.max_slots = max_slots
        self.bytes_per_slot = bytes_per_slot
        self.byte_budget = byte_budget
        self.max_prefill_per_step = max_prefill_per_step
        self.max_queue = max_queue
        self._queue: deque[Request] = deque()
        self._resident = 0
        self.admitted = 0
        self.rejected = 0
        self.terminal_counts = {DONE: 0, CANCELLED: 0, DROPPED: 0,
                                FAILED: 0, MIGRATED: 0}
        #: optional repro_torch.obs Tracer; queue-wait spans are owned here
        #: because every QUEUED<->resident transition runs through the
        #: scheduler, so TTFT's queue segment can't drift from the real
        #: state machine
        self.tracer = None

    # -- queue-wait spans --------------------------------------------------
    @staticmethod
    def _tid(req: Request):
        # the trace id spans carry: the fleet gid when the router set one
        # (key_id), else the local rid — same rule as the sampler keys
        return req.key_id if req.key_id is not None else req.rid

    def _queue_begin(self, req: Request, reason: str) -> None:
        if self.tracer is not None:
            req.span_ids["queue"] = self.tracer.begin(
                "queue", trace=self._tid(req),
                parent=req.span_ids.get("req"), reason=reason)

    def _queue_end(self, req: Request, **attrs) -> None:
        if self.tracer is not None:
            self.tracer.end(req.span_ids.pop("queue", None), **attrs)

    # ----------------------------------------------------------------------
    def submit(self, req: Request, *, front: bool = False) -> None:
        """Queue a request; ``front=True`` joins at the HEAD of the line
        (the fleet router's migration path — the request already waited
        its FCFS turn on the replica it left)."""
        if req.state != QUEUED:
            raise ValueError(f"Scheduler.submit: request {req.rid} is "
                             f"{req.state}, expected {QUEUED}")
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self.rejected += 1
            raise AdmissionRejected(
                f"Scheduler: queue full ({len(self._queue)}/{self.max_queue})"
                f" — request {req.rid} rejected (backpressure)")
        if front:
            self._queue.appendleft(req)
        else:
            self._queue.append(req)
        self._queue_begin(req, "replay" if front else "submit")

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def resident(self) -> int:
        return self._resident

    def has_work(self) -> bool:
        return bool(self._queue) or self._resident > 0

    def _budget_admits(self) -> bool:
        if self.byte_budget is None or self.bytes_per_slot <= 0:
            return True
        return (self._resident + 1) * self.bytes_per_slot <= self.byte_budget

    def shed_expired(self, now_step: int) -> list[Request]:
        """Drop queued requests whose queue wait exceeded their deadline.

        The TTL counts from ``arrival_step`` — a replayed request's
        backoff resets it.  Expired requests are shed wherever they sit
        in the line (a dead head must not block live requests behind
        it).  Returns the shed requests, now ``DROPPED``.
        """
        shed: list[Request] = []
        keep: deque[Request] = deque()
        for req in self._queue:
            if (req.deadline_steps is not None
                    and now_step - req.arrival_step > req.deadline_steps):
                req.state = DROPPED
                self.terminal_counts[DROPPED] += 1
                self._queue_end(req, state=DROPPED)
                shed.append(req)
            else:
                keep.append(req)
        self._queue = keep
        return shed

    def remove_queued(self, req: Request, state: str = CANCELLED) -> None:
        """Remove a still-queued request from the line into a terminal
        state (``CANCELLED`` by default; the router uses ``MIGRATED``)."""
        if req.state != QUEUED:
            raise ValueError(f"Scheduler.remove_queued: request {req.rid} "
                             f"is {req.state}")
        if state not in TERMINAL:
            raise ValueError(f"Scheduler.remove_queued: {state} is not "
                             f"terminal")
        self._queue.remove(req)
        req.state = state
        self.terminal_counts[state] += 1
        self._queue_end(req, state=state)

    def cancel_queued(self, req: Request) -> None:
        """Remove a still-queued request from the line -> ``CANCELLED``."""
        self.remove_queued(req, CANCELLED)

    def pop_admissible(self, free_slots: int, now_step: int) -> list[Request]:
        """FCFS head-of-line admission for this engine step.

        Strict FCFS: if the head request can't join (no slot, budget, not
        yet arrived), nothing behind it jumps the line — latency stays
        predictable and starvation-free.  A replayed request backing off
        at the head blocks the line for its backoff window; that keeps
        replay deterministic and is documented in serve/README.md.
        """
        out: list[Request] = []
        while (self._queue and free_slots > 0
               and len(out) < self.max_prefill_per_step
               and self._queue[0].arrival_step <= now_step
               and self._budget_admits()):
            req = self._queue.popleft()
            req.state = PREFILL
            self._resident += 1
            self.admitted += 1
            free_slots -= 1
            self._queue_end(req, state=PREFILL)
            out.append(req)
        return out

    def requeue(self, req: Request, arrival_step: int) -> None:
        """Put a resident request back at the HEAD of the queue (replay
        path): it already waited its FCFS turn, so it does not go to the
        back; ``arrival_step`` carries the retry backoff."""
        if req.state not in (PREFILL, DECODE):
            raise ValueError(f"Scheduler.requeue: request {req.rid} is "
                             f"{req.state}")
        req.state = QUEUED
        req.arrival_step = arrival_step
        self._resident -= 1
        assert self._resident >= 0, "scheduler resident count underflow"
        self._queue.appendleft(req)
        self._queue_begin(req, "replay")

    def retire(self, req: Request, state: str = DONE) -> None:
        """Move a resident request to a terminal state (default DONE)."""
        if req.state not in (PREFILL, DECODE):
            raise ValueError(f"Scheduler.retire: request {req.rid} is "
                             f"{req.state}")
        if state not in TERMINAL:
            raise ValueError(f"Scheduler.retire: {state} is not terminal")
        req.state = state
        self.terminal_counts[state] += 1
        self._resident -= 1
        assert self._resident >= 0, "scheduler resident count underflow"

    def state_counts(self) -> dict:
        """Live + terminal request counts — the stall diagnostic."""
        return {QUEUED: len(self._queue), "RESIDENT": self._resident,
                **dict(self.terminal_counts), "REJECTED": self.rejected}
