"""Seeded fault injection for the serve engine (a port of
``repro.serve.faults``) — the proof harness for the detect → quarantine →
recover path.

A :class:`FaultPlan` is a deterministic schedule of :class:`FaultEvent`\\ s
keyed by engine step; a :class:`FaultInjector` installs itself into
``ServeEngine.hooks`` and fires the events as the engine crosses each
step.  Everything here is HOST-side: injection writes into the pool
cache's tensors between dispatches (in place, allocating nothing) or
filters a scatter call — it never wraps a kernel or the decode round.

Fault kinds and what they exercise:

``nan_logits``
    NaN the victim slot's cache scale rows (or raw K/V rows on an
    unquantized pool) → the next decode's logits for that slot are NaN →
    the all-finite sentinel trips.  Per-slot attention means ONLY the
    poisoned slot trips; neighbors keep decoding.
``corrupt_row``
    Overwrite the rows with ``3.4e38`` → the attention matmul overflows
    to inf → non-finite logits.  Same detection path, different poison —
    models a corrupted (not merely NaN'd) cache row.
``drop_scatter``
    Suppress the admission-time ``scatter_request`` call via the
    ``scatter_filter`` hook → the slot's ``pos`` stays 0 → the
    sentinel's scattered-prompt check (``pos > 0``) trips on the first
    decode round.
``cancel``
    Call ``engine.cancel(rid)`` at the scheduled step (queued or
    resident) — cancellation storms.

Replica-scoped kinds target a whole fleet member and are fired
by :class:`FleetFaultInjector` against a ``Router`` (a per-engine
:class:`FaultInjector` ignores them):

``replica_crash``
    ``router.kill(replica)`` — the replica dies mid-flight; its queued
    AND resident requests fail over to the survivors from the router's
    mirrored token log.
``replica_sick``
    Poison one resident slot's cache rows on the replica → its decode
    sentinel trips → the fault feeds the router's error-budget circuit
    breaker (HEALTHY → DEGRADED → QUARANTINED as faults accumulate).
``replica_slow``
    ``router.pause(replica, duration)`` — the replica stops making
    progress for ``duration`` router steps; the breaker's stall detector
    (resident > 0, zero tokens emitted) quarantines it if the pause
    outlasts ``stall_steps``.
``worker_sigkill``
    ``engine.terminate()`` on a subprocess replica
    (:class:`~repro_torch.serve.worker.WorkerProxy`) — a REAL ``SIGKILL``
    fired WITHOUT telling the router (unlike ``replica_crash``, which
    is the router's own kill path).  The breaker has to notice on its
    own: the proxy's heartbeat stops, its counters freeze, the stall
    detector trips, and quarantine evacuates the victims.  Kept in
    ``WORKER_KINDS`` (not ``REPLICA_KINDS``) so :func:`chaos_plan`'s
    seeded draws over the default kind set are unchanged.

Crash-at-every-point harness, for the DURABLE serving plane:
:class:`SimulatedCrash` + :func:`crash_after_appends` arm the journal's
``post_append`` hook to kill the router at the N-th write-ahead append —
after the record hit disk, before the router acted on it (the
append-vs-placement window); :func:`tear_tail` truncates a journal
mid-final-record to model a crash mid-write.  Sweeping N over a seeded
subset of append indices is the "kill -9 at an arbitrary point" proof.

Recovery contract (what the tests assert): the quarantined slot passes a
pool audit and returns to the free list; the victim replays from prompt
+ already-emitted tokens, so a surviving request's final token stream is
exactly the fault-free greedy stream; drained pools show zero slot leaks
(``allocs == frees``, occupancy 0).
"""
from __future__ import annotations

import dataclasses
import os
from collections import Counter
from typing import Iterable, Optional

import numpy as np

KINDS = ("nan_logits", "corrupt_row", "drop_scatter", "cancel")
#: fleet-level kinds, fired by FleetFaultInjector at ROUTER steps
REPLICA_KINDS = ("replica_crash", "replica_sick", "replica_slow")
#: subprocess-worker kinds — separate tuple: appending to REPLICA_KINDS
#: would shift chaos_plan's seeded rng.randint(len(kinds)) draws
WORKER_KINDS = ("worker_sigkill",)


class SimulatedCrash(RuntimeError):
    """Raised by the crash harness to model ``kill -9``: the process is
    gone mid-operation, no cleanup runs, only the journal survives."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``step`` is the engine step it fires at;
    the victim is named by ``rid`` (preferred — slots get recycled) or a
    raw ``slot``; ``drop_scatter`` with neither hits every admission at
    that step."""
    step: int
    kind: str
    rid: Optional[int] = None
    slot: Optional[int] = None
    replica: Optional[int] = None         # fleet kinds: which replica
    duration: Optional[int] = None        # replica_slow: pause length

    def __post_init__(self):
        known = KINDS + REPLICA_KINDS + WORKER_KINDS
        if self.kind not in known:
            raise ValueError(f"FaultEvent: unknown kind {self.kind!r} "
                             f"(expected one of {known})")
        if self.step < 0:
            raise ValueError("FaultEvent: step must be >= 0")
        if self.kind == "cancel" and self.rid is None:
            raise ValueError("FaultEvent: cancel needs a rid")
        if self.kind in REPLICA_KINDS + WORKER_KINDS \
                and self.replica is None:
            raise ValueError(f"FaultEvent: {self.kind} needs a replica")


class FaultPlan:
    """A deterministic, step-keyed schedule of faults.

    Build with the fluent helpers::

        plan = (FaultPlan()
                .nan_logits(step=4, rid=0)
                .corrupt_row(step=9, rid=2)
                .drop_scatter(step=2)
                .cancel(step=6, rid=3))
    """

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self.events: list[FaultEvent] = list(events)

    def add(self, step: int, kind: str, *, rid: Optional[int] = None,
            slot: Optional[int] = None, replica: Optional[int] = None,
            duration: Optional[int] = None) -> "FaultPlan":
        self.events.append(FaultEvent(step=step, kind=kind, rid=rid,
                                      slot=slot, replica=replica,
                                      duration=duration))
        return self

    def nan_logits(self, step: int, *, rid: Optional[int] = None,
                   slot: Optional[int] = None) -> "FaultPlan":
        return self.add(step, "nan_logits", rid=rid, slot=slot)

    def corrupt_row(self, step: int, *, rid: Optional[int] = None,
                    slot: Optional[int] = None) -> "FaultPlan":
        return self.add(step, "corrupt_row", rid=rid, slot=slot)

    def drop_scatter(self, step: int,
                     rid: Optional[int] = None) -> "FaultPlan":
        return self.add(step, "drop_scatter", rid=rid)

    def cancel(self, step: int, rid: int) -> "FaultPlan":
        return self.add(step, "cancel", rid=rid)

    def replica_crash(self, step: int, replica: int) -> "FaultPlan":
        return self.add(step, "replica_crash", replica=replica)

    def replica_sick(self, step: int, replica: int, *,
                     rid: Optional[int] = None) -> "FaultPlan":
        return self.add(step, "replica_sick", replica=replica, rid=rid)

    def replica_slow(self, step: int, replica: int, *,
                     duration: int = 8) -> "FaultPlan":
        return self.add(step, "replica_slow", replica=replica,
                        duration=duration)

    def worker_sigkill(self, step: int, replica: int) -> "FaultPlan":
        return self.add(step, "worker_sigkill", replica=replica)

    def at(self, step: int, kind: Optional[str] = None) -> list[FaultEvent]:
        return [e for e in self.events
                if e.step == step and (kind is None or e.kind == kind)]

    def counts(self) -> Counter:
        return Counter(e.kind for e in self.events)

    def __len__(self) -> int:
        return len(self.events)


def poison_slot(engine, slot: int, value: float) -> None:
    """Overwrite one slot's cache rows in place, between dispatches.
    The pool's tensors keep their storage, shapes and dtypes (nothing is
    allocated); the next decode round reads the poison."""
    cache = engine.pool.cache
    names = [n for n in ("k_scale", "v_scale") if n in cache]
    if not names:                           # unquantized pool: raw K/V rows
        names = [n for n in ("k", "v") if n in cache]
    for n in names:
        # every leaf is (L, B, ...) with the slot axis at B
        cache[n][:, slot].fill_(value)


class FaultInjector:
    """Wires a :class:`FaultPlan` into an engine's host-side hooks.

    ``injected`` counts the faults that actually LANDED (a nan_logits
    aimed at a request that already finished lands nowhere), and
    ``victims`` records the rids hit by cache poison / dropped scatters —
    tests reconcile both against the engine summary.
    """

    def __init__(self, engine, plan: FaultPlan):
        self.engine = engine
        self.plan = plan
        self.injected: Counter = Counter()
        self.victims: set[int] = set()
        engine.hooks["pre_step"] = self._pre_step
        engine.hooks["pre_decode"] = self._pre_decode
        engine.hooks["scatter_filter"] = self._scatter_filter

    def uninstall(self) -> None:
        for name in ("pre_step", "pre_decode", "scatter_filter"):
            self.engine.hooks.pop(name, None)

    # -- hook bodies ---------------------------------------------------------
    def _pre_step(self, engine) -> None:
        for e in self.plan.at(engine.step_no, "cancel"):
            if engine.cancel(e.rid):
                self.injected["cancel"] += 1

    def _resolve_slot(self, e: FaultEvent) -> Optional[int]:
        """Victim slot for a cache-poison event, or None if it has no
        resident target right now (request finished / not yet admitted)."""
        if e.rid is not None:
            req = self.engine._requests.get(e.rid)
            return req.slot if req is not None else None
        if e.slot is not None and e.slot in self.engine._slot_req:
            return e.slot
        return None

    def _pre_decode(self, engine) -> None:
        for e in self.plan.at(engine.step_no, "nan_logits"):
            slot = self._resolve_slot(e)
            if slot is not None:
                poison_slot(engine, slot, float("nan"))
                self.injected["nan_logits"] += 1
                self.victims.add(engine._slot_req[slot].rid)
        for e in self.plan.at(engine.step_no, "corrupt_row"):
            slot = self._resolve_slot(e)
            if slot is not None:
                poison_slot(engine, slot, 3.4e38)
                self.injected["corrupt_row"] += 1
                self.victims.add(engine._slot_req[slot].rid)

    def _scatter_filter(self, engine, req, slot) -> bool:
        for e in self.plan.at(engine.step_no, "drop_scatter"):
            if e.rid is None or e.rid == req.rid:
                self.injected["drop_scatter"] += 1
                self.victims.add(req.rid)
                return False
        return True


class FleetFaultInjector:
    """Wires a :class:`FaultPlan`'s replica-scoped events into a
    ``Router``'s ``pre_step`` hook (events fire at ROUTER steps).

    ``injected`` counts events that landed; ``crashed``/``paused``/
    ``sickened`` record which replicas were hit — the chaos acceptance
    tests reconcile these against the fleet summary.
    """

    def __init__(self, router, plan: FaultPlan):
        self.router = router
        self.plan = plan
        self.injected: Counter = Counter()
        self.crashed: set[int] = set()
        self.sickened: set[int] = set()
        self.paused: set[int] = set()
        self.sigkilled: set[int] = set()
        router.hooks["pre_step"] = self._pre_step

    def uninstall(self) -> None:
        self.router.hooks.pop("pre_step", None)

    def _pre_step(self, router) -> None:
        step = router.step_no
        for e in self.plan.at(step, "replica_crash"):
            if router.kill(e.replica):
                self.injected["replica_crash"] += 1
                self.crashed.add(e.replica)
        for e in self.plan.at(step, "worker_sigkill"):
            # a REAL SIGKILL behind the router's back: only subprocess
            # replicas (WorkerProxy.terminate) can take one — the router
            # finds out through its own stall detector, not from us
            term = getattr(router.engines[e.replica], "terminate", None)
            if callable(term) and term():
                self.injected["worker_sigkill"] += 1
                self.sigkilled.add(e.replica)
        for e in self.plan.at(step, "replica_sick"):
            engine = router.engines[e.replica]
            if router.health[e.replica] == "DEAD":
                continue
            # poison one resident slot (rid-targeted if asked, else the
            # lowest live slot) — the replica's OWN sentinel detects it
            slot = None
            if hasattr(engine, "_slot_req"):          # in-process engine
                if e.rid is not None:
                    req = engine._requests.get(e.rid)
                    slot = req.slot if req is not None else None
                elif engine._slot_req:
                    slot = min(engine._slot_req)
                if slot is not None:
                    poison_slot(engine, slot, float("nan"))
            else:
                # subprocess replica: resolve the victim from the
                # proxy's request mirror and poison over the RPC — the
                # sentinel trips INSIDE the worker process
                views = getattr(engine, "_requests", {})
                if e.rid is not None:
                    v = views.get(e.rid)
                    slot = v.slot if v is not None else None
                else:
                    slots = [v.slot for v in views.values()
                             if v.slot is not None
                             and v.state not in ("DONE", "CANCELLED",
                                                 "DROPPED", "FAILED",
                                                 "MIGRATED")]
                    slot = min(slots) if slots else None
                if slot is not None and not engine.poison_slot(
                        slot, float("nan")):
                    slot = None
            if slot is not None:
                self.injected["replica_sick"] += 1
                self.sickened.add(e.replica)
        for e in self.plan.at(step, "replica_slow"):
            if router.pause(e.replica, e.duration or 8):
                self.injected["replica_slow"] += 1
                self.paused.add(e.replica)


def crash_after_appends(journal, n: int) -> dict:
    """Arm a :class:`SimulatedCrash` at the ``n``-th write-ahead append
    (1-indexed, counted from arming).

    The journal fires ``post_append`` AFTER the record is durable and
    reduced into its state, BEFORE the caller acts on it — so crashing
    there at a ``wal_submit`` is precisely the "kill -9 between journal
    append and placement" window.  The hook uninstalls itself when it
    fires (the process is "dead"; nothing else runs).  Returns a live
    counter dict: ``{"appends": seen, "fired": bool}``."""
    if n < 1:
        raise ValueError("crash_after_appends: n must be >= 1")
    state = {"appends": 0, "fired": False}

    def _hook(j, kind, rec):
        state["appends"] += 1
        if state["appends"] >= n:
            state["fired"] = True
            j.hooks.pop("post_append", None)
            raise SimulatedCrash(
                f"kill -9 after append {state['appends']} ({kind})")

    journal.hooks["post_append"] = _hook
    return state


def tear_tail(path: str, nbytes: Optional[int] = None) -> int:
    """Truncate a journal mid-final-record — the torn tail a crash
    leaves when it lands inside a write.  Cuts ``nbytes`` off the end
    (default: half the final record, at least 1 byte, keeping the
    record's leading bytes so the tail is INVALID JSON rather than
    merely absent).  Returns the new file size."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        data = f.read()
    body = data[:-1] if data.endswith(b"\n") else data
    last_nl = body.rfind(b"\n")
    last_len = len(data) - (last_nl + 1)
    if nbytes is None:
        nbytes = max(1, last_len // 2)
    nbytes = min(nbytes, size)
    with open(path, "r+b") as f:
        f.truncate(size - nbytes)
    return size - nbytes


def chaos_plan(seed: int, *, steps: int, replicas: int,
               n_events: int = 4,
               kinds: tuple = REPLICA_KINDS) -> FaultPlan:
    """Seeded random replica-fault schedule: the chaos harness.  Same
    seed -> same plan, so a chaos run is exactly replayable."""
    rng = np.random.RandomState(seed)
    plan = FaultPlan()
    for _ in range(n_events):
        kind = kinds[int(rng.randint(len(kinds)))]
        step = int(rng.randint(1, max(2, steps)))
        replica = int(rng.randint(replicas))
        if kind == "replica_slow":
            plan.replica_slow(step, replica,
                              duration=int(rng.randint(2, 10)))
        else:
            plan.add(step, kind, replica=replica)
    return plan
