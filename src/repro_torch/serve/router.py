"""Replicated serving fleet (a port of ``repro.serve.router``): an
engine-replica router with health-based failover, cross-replica request
migration, and elastic drain/rejoin.

The slot axis never shards — so the fleet dimension of serving is
replication:
N independent :class:`ServeEngine` replicas behind one
:class:`Router`.  This is serving's data parallelism, and like training
DP it only pays off if a replica can fail without losing work.

Admission
    ``least_loaded`` scores each accepting replica by
    ``queue_depth - free_slots`` (lower = more headroom) with health as
    the primary key (HEALTHY before DEGRADED) and the replica index as
    the deterministic tie-break; ``round_robin`` rotates.  When EVERY
    replica rejects (bounded queues full), the router raises
    :class:`AdmissionRejected` — fleet-level backpressure the caller
    can see.

Health — an error-budget circuit breaker per replica
    Each engine already detects its own faults (the fused decode
    sentinel).  The router folds those per-step fault counts plus
    a stall detector (resident requests but zero tokens emitted) into a
    per-replica state machine::

        HEALTHY -> DEGRADED      faults in window >= degrade_faults
        *       -> QUARANTINED   faults in window >= quarantine_faults,
                                 or stalled >= stall_steps
        QUARANTINED -> DEGRADED  after cooldown_steps (probation rejoin)
        DEGRADED -> HEALTHY      fault window empty again

    Quarantine evacuates the replica: every queued AND resident request
    migrates to the survivors.

Migration — the replay contract, fleet edition
    A migrating request re-enters a healthy replica AT THE QUEUE HEAD
    (it already waited its FCFS turn) with ``emitted=`` its healthy
    token prefix, riding the engine's own replay path: prefill over
    prompt+emitted, continue from there.  Under greedy decode the
    continuation is token-exact vs an uninterrupted run; under sampling
    the fleet requires ``sampler_keys="request"`` engines, whose
    per-request key schedule ``fold_request_key(seed, gid, draw)``
    makes token ``draw`` of request ``gid`` sample identically on ANY
    replica/slot/step — the trajectory is a pure function of the
    request, independent of placement.

Crash harvest
    ``kill(replica)`` simulates a crashed replica.  Replays come from
    the router's OWN per-step token mirror (standing in for a
    replicated request log — a real deployment cannot read a dead
    process's memory); the dead engine's ledger is closed out with
    ``MIGRATED`` evictions so both pools still audit to zero leaks.

Elasticity
    ``drain_replica`` stops admission, migrates the queued requests
    off, and lets residents finish (DRAINING -> DRAINED);
    ``rejoin`` puts a DRAINED replica back in rotation as HEALTHY, its
    model and pool still resident.

``summary()`` aggregates per-replica :class:`ServeMetrics` into fleet
metrics (goodput vs throughput, failovers, migrations, time in
quarantine) and ``reconcile()`` cross-checks the fleet request table
against every replica's ledger — each request terminal exactly once.

Durability — the write-ahead journal and whole-router crashes
    With ``journal=`` (a :class:`~repro_torch.serve.journal.RequestJournal`)
    every fleet transition is logged BEFORE the router acts on it:
    SUBMIT before placement, the healthy token deltas at every harvest,
    exactly one TERMINAL per request.  After a whole-router ``kill -9``,
    ``Router.recover()`` on a FRESH fleet rebuilds the request table
    from the journal's reduced state and re-submits every live request
    from its prompt + durably-logged tokens — the engine regenerates
    the (possibly lost) fsync-lag suffix deterministically, so greedy
    recovery is token-exact and sampled recovery key-exact under
    ``sampler_keys="request"``.  ``reconcile()`` then additionally
    proves every journaled SUBMIT reached exactly one TERMINAL.

    Subprocess replicas (:class:`~repro_torch.serve.worker.WorkerProxy`) slot
    into the same fleet: ``kill()`` becomes a real SIGKILL, and the
    stall detector treats a dead worker holding work as stalled (its
    RPC heartbeat stopped), so the breaker quarantines and evacuates it
    across the process boundary.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serve.metrics import fleet_summary
from repro_torch.serve.scheduler import (CANCELLED, DONE, DROPPED, FAILED,
                                         MIGRATED, QUEUED, TERMINAL,
                                         AdmissionRejected)
from repro_torch.serve.trace import TraceRequest

#: replica health states (the circuit breaker's machine)
HEALTHY, DEGRADED, QUARANTINED = "HEALTHY", "DEGRADED", "QUARANTINED"
DRAINING, DRAINED, DEAD = "DRAINING", "DRAINED", "DEAD"
#: states in which a replica accepts new work
ACCEPTING = frozenset({HEALTHY, DEGRADED})

ROUTE_POLICIES = ("least_loaded", "round_robin")


@dataclasses.dataclass
class BreakerConfig:
    """Error-budget circuit breaker knobs (see module docstring)."""
    window_steps: int = 32        # sliding fault window (router steps)
    degrade_faults: int = 1       # faults in window -> DEGRADED
    quarantine_faults: int = 3    # faults in window -> QUARANTINED
    cooldown_steps: int = 16      # quarantine length before probation
    stall_steps: int = 8          # no-progress steps -> QUARANTINED

    def __post_init__(self):
        if self.window_steps < 1 or self.cooldown_steps < 1 \
                or self.stall_steps < 1:
            raise ValueError("BreakerConfig: window/cooldown/stall steps "
                             "must be >= 1")
        if not (1 <= self.degrade_faults <= self.quarantine_faults):
            raise ValueError("BreakerConfig: need 1 <= degrade_faults <= "
                             "quarantine_faults")


@dataclasses.dataclass
class FleetRequest:
    """One request at FLEET scope.  ``gid`` is the fleet-global id (and
    the sampler-key identity on every replica); ``tokens`` is the
    router's mirror of the healthy emitted stream — the crash-harvest
    source."""
    gid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    deadline_steps: Optional[int] = None
    state: str = QUEUED                   # fleet-level lifecycle
    replica: Optional[int] = None         # current placement
    local_rid: Optional[int] = None       # rid on that replica
    tokens: list = dataclasses.field(default_factory=list)
    migrations: int = 0                   # successful re-placements
    placements: list = dataclasses.field(default_factory=list)
    # open span ids ("fleet_req"/"migrate") when tracing is on
    span_ids: dict = dataclasses.field(default_factory=dict)


class Router:
    """Fronts N warmed ServeEngine replicas (see module docstring)."""

    def __init__(self, engines: Sequence, *, policy: str = "least_loaded",
                 breaker: Optional[BreakerConfig] = None,
                 max_migrations: int = 2, sink=None, journal=None,
                 journal_tokens_every: int = 1):
        if journal_tokens_every < 1:
            raise ValueError("Router: journal_tokens_every must be >= 1")
        if not engines:
            raise ValueError("Router: need at least one engine replica")
        if policy not in ROUTE_POLICIES:
            raise ValueError(f"Router: unknown policy {policy!r} "
                             f"(expected one of {ROUTE_POLICIES})")
        for i, e in enumerate(engines):
            if e.scheduler.has_work():
                raise ValueError(f"Router: replica {i} has in-flight "
                                 f"requests — pass freshly warmed engines")
            if e.temperature > 0.0 and e.sampler_keys != "request":
                raise ValueError(
                    f"Router: replica {i} samples with per-step keys; a "
                    f"fleet needs sampler_keys='request' so migrated "
                    f"trajectories are placement-independent")
            if e.metrics.replica is None:
                e.metrics.replica = i
        self.engines = list(engines)
        self.policy = policy
        self.breaker = breaker if breaker is not None else BreakerConfig()
        self.max_migrations = max_migrations
        self.sink = sink
        n = len(self.engines)
        self.health: list[str] = [HEALTHY] * n
        self.hooks: dict[str, Callable] = {}   # chaos harness seam
        self._step_no = 0
        self._next_gid = 0
        self._rr = 0                           # round-robin cursor
        self._reqs: dict[int, FleetRequest] = {}
        self._local2gid: list[dict] = [dict() for _ in range(n)]
        self._pending: deque[FleetRequest] = deque()  # awaiting placement
        self._fault_marks: list[deque] = [deque() for _ in range(n)]
        self._fault_seen: list[int] = [0] * n  # engine fault counter snap
        self._tokens_seen: list[int] = [0] * n # progress snapshot
        self._stalled: list[int] = [0] * n     # consecutive no-progress
        self._quarantined_at: list[Optional[int]] = [None] * n
        self._paused: list[int] = [0] * n      # replica_slow countdown
        #: fleet-scope metrics (rejected/failovers/migrations/health
        #: transitions); per-replica registries merge in via
        #: ``registry_snapshot()``
        self.registry = MetricsRegistry()
        #: optional repro_torch.obs Tracer for fleet_req/place/migrate/recover
        #: spans — attach before submitting (every emission is guarded,
        #: so leaving it None costs nothing)
        self.tracer = None
        self.time_in_quarantine: list[int] = [0] * n
        #: write-ahead request journal (attach at construction so every
        #: SUBMIT is journaled — a mid-run attach would leave earlier
        #: terminals unaccounted)
        self.journal = journal
        #: token-journaling cadence: wal_tokens deltas flush every N
        #: router steps (and always at a terminal).  Token records only
        #: bound how much a recovery must REGENERATE — replay is
        #: deterministic either way — so a cadence > 1 trades a wider
        #: fsync-lag window for one append per request per N steps
        self.journal_tokens_every = journal_tokens_every
        self._recovered_done = 0        # DONE straight from the journal
        self._journal_recovered: list[int] = []   # gids recover() rebuilt

    # legacy counters, now registry-backed ----------------------------------
    @property
    def rejected(self) -> int:             # fleet-level backpressure
        return self.registry.count("fleet.rejected")

    @property
    def failovers(self) -> int:            # crash/quarantine/FAILED moves
        return self.registry.count("fleet.failovers")

    @property
    def migrations(self) -> int:           # successful re-placements
        return self.registry.count("fleet.migrations")

    def registry_snapshot(self) -> dict:
        """Fleet-wide registry view: the router's own counters merged
        with every replica's snapshot — across the RPC boundary for
        subprocess workers (their ``_MetricsView`` caches the snapshot
        from the last harvest, so a dead worker's last-known metrics
        still count)."""
        snap = self.registry.snapshot()
        for e in self.engines:
            get = getattr(e.metrics, "registry_snapshot", None)
            s = get() if get is not None else None
            if s:
                snap = MetricsRegistry.merge(snap, s)
        return snap

    # -- events ------------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        if self.sink is not None:
            self.sink.emit(kind, step=self._step_no, **fields)

    def _set_health(self, i: int, state: str, reason: str = "") -> None:
        if self.health[i] == state:
            return
        self._event("health", replica=i, frm=self.health[i], to=state,
                    reason=reason)
        self.registry.inc(f"fleet.health.{state}")
        self.health[i] = state

    def _fleet_terminal(self, fr: FleetRequest, state: str,
                        **fields) -> None:
        """The ONE place a fleet request goes terminal: set the state,
        emit the event, and close the journal entry (exactly one
        wal_terminal per journaled submit — ``reconcile`` proves it)."""
        fr.state = state
        self._event("fleet_terminal", gid=fr.gid, state=state, **fields)
        if self.journal is not None:
            self.journal.terminal(fr.gid, state, n_tokens=len(fr.tokens))
        if self.tracer is not None:
            self.tracer.end(fr.span_ids.pop("migrate", None), state=state)
            self.tracer.end(fr.span_ids.pop("recover", None), state=state)
            self.tracer.end(fr.span_ids.pop("fleet_req", None), state=state,
                            tokens=len(fr.tokens))

    # -- placement ---------------------------------------------------------
    @property
    def step_no(self) -> int:
        return self._step_no

    def _accepting(self) -> list[int]:
        return [i for i, h in enumerate(self.health) if h in ACCEPTING]

    def _rank(self, candidates: list[int]) -> list[int]:
        """Admission order over accepting replicas."""
        if self.policy == "round_robin":
            n = len(self.engines)
            order = sorted(candidates, key=lambda i: (i - self._rr) % n)
            return order
        # least_loaded: HEALTHY first, then most headroom, then index
        def score(i):
            e = self.engines[i]
            load = e.scheduler.queue_depth - e.pool.free_slots
            return (0 if self.health[i] == HEALTHY else 1, load, i)
        return sorted(candidates, key=score)

    def _place(self, fr: FleetRequest, *, front: bool) -> bool:
        """Try to put ``fr`` on some accepting replica.  Returns False
        when every candidate rejected (callers decide between fleet
        backpressure and the pending-migration queue)."""
        sid = None if self.tracer is None else self.tracer.begin(
            "place", trace=fr.gid, parent=fr.span_ids.get("fleet_req"),
            front=front)
        try:
            for i in self._rank(self._accepting()):
                try:
                    rid = self.engines[i].submit(
                        fr.prompt, fr.max_new_tokens, eos_id=fr.eos_id,
                        deadline_steps=fr.deadline_steps, front=front,
                        key_id=fr.gid,
                        emitted=fr.tokens if fr.tokens else None)
                except AdmissionRejected:
                    continue
                if self.policy == "round_robin":
                    self._rr = (i + 1) % len(self.engines)
                fr.replica, fr.local_rid = i, rid
                fr.placements.append((i, rid))
                self._local2gid[i][rid] = fr.gid
                self._event("place", gid=fr.gid, replica=i, rid=rid,
                            front=front, emitted=len(fr.tokens))
                if self.journal is not None:
                    self.journal.place(fr.gid, i, rid, front=front,
                                       emitted=len(fr.tokens))
                if self.tracer is not None:
                    self.tracer.end(sid, placed=True, replica=i, rid=rid)
                return True
        except ValueError:
            # replay prompt outgrew the buckets — close the span before
            # the caller escalates to a fleet-level FAILED
            if self.tracer is not None:
                self.tracer.end(sid, placed=False, error="bucket")
            raise
        if self.tracer is not None:
            self.tracer.end(sid, placed=False)
        return False

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None,
               deadline_steps: Optional[int] = None) -> int:
        """Admit one request to the fleet; returns its gid.  Raises
        :class:`AdmissionRejected` when every accepting replica's
        bounded queue is full (fleet backpressure)."""
        fr = FleetRequest(gid=self._next_gid,
                          prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=max_new_tokens, eos_id=eos_id,
                          deadline_steps=deadline_steps)
        if self.tracer is not None:
            fr.span_ids["fleet_req"] = self.tracer.begin(
                "fleet_req", trace=fr.gid, prompt_len=len(fr.prompt),
                max_new_tokens=max_new_tokens)
        if self.journal is not None:
            # WRITE-AHEAD: the submit hits disk BEFORE placement, so a
            # crash between the two still recovers the request — which
            # also means the gid is consumed (and a rejection must close
            # the journal entry with its own terminal)
            self.journal.submit(fr.gid, fr.prompt, fr.max_new_tokens,
                                fr.eos_id, fr.deadline_steps)
        if not self._place(fr, front=False):
            self.registry.inc("fleet.rejected")
            self._event("fleet_reject", gid=fr.gid)
            if self.journal is not None:
                self._next_gid += 1
                self.journal.terminal(fr.gid, "REJECTED")
            if self.tracer is not None:
                self.tracer.end(fr.span_ids.pop("fleet_req", None),
                                state="REJECTED", tokens=0)
            raise AdmissionRejected(
                f"Router: every accepting replica rejected request "
                f"{fr.gid} (fleet backpressure)")
        self._next_gid += 1
        self._reqs[fr.gid] = fr
        return fr.gid

    def cancel(self, gid: int) -> bool:
        """Cancel a fleet request wherever it lives.  Idempotent."""
        fr = self._reqs.get(gid)
        if fr is None or fr.state in TERMINAL:
            return False
        if fr in self._pending:
            self._pending.remove(fr)
        elif fr.replica is not None:
            self.engines[fr.replica].evict_request(fr.local_rid, CANCELLED)
            self._local2gid[fr.replica].pop(fr.local_rid, None)
        self._fleet_terminal(fr, CANCELLED)
        return True

    # -- failover ----------------------------------------------------------
    def _migrate(self, fr: FleetRequest, reason: str) -> None:
        """Queue ``fr`` for re-placement on a healthy replica (queue
        HEAD on arrival).  Over-budget requests fail at fleet level
        instead of ping-ponging forever."""
        fr.replica, fr.local_rid = None, None
        if fr.migrations >= self.max_migrations:
            self._fleet_terminal(
                fr, FAILED,
                reason=f"migration budget exhausted ({reason})")
            return
        self.registry.inc("fleet.failovers")
        self._event("failover", gid=fr.gid, reason=reason,
                    emitted=len(fr.tokens))
        if self.tracer is not None and "migrate" not in fr.span_ids:
            # one migrate span covers failover -> successful re-placement,
            # including any time parked in the pending queue
            fr.span_ids["migrate"] = self.tracer.begin(
                "migrate", trace=fr.gid,
                parent=fr.span_ids.get("fleet_req"), reason=reason,
                emitted=len(fr.tokens))
        if self.journal is not None:
            self.journal.migrate(fr.gid, reason)
        try:
            placed = self._place(fr, front=True)
        except ValueError:
            # replay prompt outgrew every replica's buckets — the same
            # escalation the engine-internal replay path takes
            self._fleet_terminal(fr, FAILED,
                                 reason="replay prompt exceeds buckets")
            return
        if placed:
            fr.migrations += 1
            self.registry.inc("fleet.migrations")
            if self.tracer is not None:
                self.tracer.end(fr.span_ids.pop("migrate", None),
                                replica=fr.replica)
        else:
            self._pending.append(fr)      # retried every router step

    def _evacuate(self, i: int, reason: str) -> int:
        """Migrate every live request off replica ``i`` (quarantine /
        crash / drain-queued paths).  Replays harvest from the ROUTER's
        token mirror, not the replica's memory."""
        moved = 0
        for rid, gid in list(self._local2gid[i].items()):
            self.engines[i].evict_request(rid, MIGRATED)
            self._local2gid[i].pop(rid, None)
            self._migrate(self._reqs[gid], reason)
            moved += 1
        return moved

    def kill(self, i: int) -> bool:
        """Replica crash: evacuate everything (from the router's
        mirrored token log), close the dead ledger, and stop scheduling
        the replica.  On a subprocess replica
        (:class:`~repro_torch.serve.worker.WorkerProxy`) this is a REAL
        ``SIGKILL`` — the proxy's mirror then stands in for the dead
        process's memory, exactly like a real deployment's request log.
        Returns False if already dead."""
        if self.health[i] == DEAD:
            return False
        term = getattr(self.engines[i], "terminate", None)
        if callable(term):
            term()                       # SIGKILL the worker subprocess
        self._set_health(i, DEAD, "crash")
        self._evacuate(i, f"replica {i} crashed")
        return True

    def pause(self, i: int, steps: int) -> bool:
        """Stop stepping replica ``i`` for ``steps`` router steps (the
        ``replica_slow`` chaos event).  The stall detector decides
        whether the pause is long enough to quarantine."""
        if self.health[i] in (DEAD,) or steps < 1:
            return False
        self._paused[i] = max(self._paused[i], steps)
        self._event("pause", replica=i, steps=steps)
        return True

    def drain_replica(self, i: int) -> None:
        """Elastic scale-down: stop admitting to replica ``i``, migrate
        its QUEUED requests to the survivors, and let residents finish
        (DRAINING -> DRAINED as they retire)."""
        if self.health[i] in (DEAD, DRAINED, DRAINING):
            return
        self._set_health(i, DRAINING, "drain requested")
        for rid, gid in list(self._local2gid[i].items()):
            req = self.engines[i]._requests.get(rid)
            if req is not None and req.state == QUEUED:
                self.engines[i].evict_request(rid, MIGRATED)
                self._local2gid[i].pop(rid, None)
                self._migrate(self._reqs[gid], f"replica {i} draining")

    def rejoin(self, i: int) -> None:
        """Warm rejoin of a DRAINED replica: its model and pool are still
        resident, so it re-enters rotation at once."""
        if self.health[i] != DRAINED:
            raise ValueError(f"Router.rejoin: replica {i} is "
                             f"{self.health[i]}, only DRAINED replicas "
                             f"rejoin (quarantine rejoins itself after "
                             f"cooldown; DEAD replicas need a restart)")
        self._fault_marks[i].clear()
        self._stalled[i] = 0
        self._fault_seen[i] = self.engines[i].metrics.faults
        self._tokens_seen[i] = self.engines[i].metrics.tokens_emitted
        self._set_health(i, HEALTHY, "rejoin")

    # -- whole-router crash recovery ----------------------------------------
    def recover(self, journal=None) -> dict:
        """Rebuild fleet state from the write-ahead journal after a
        whole-router crash (this router object is a FRESH fleet; the
        crashed one is gone — ``kill -9`` leaves nothing else).

        Every request the journal shows live — submitted, not yet
        terminal, at ANY crash point including between the wal_submit
        append and its placement — is re-entered with its durably-logged
        token prefix (``emitted=``), riding the engine's deterministic
        replay path: tokens past the last durable record (the fsync-lag
        window) are REGENERATED, token-exact under greedy and key-exact
        under ``sampler_keys="request"`` (the gid is the key identity).
        A recovered request whose durable tokens already meet its budget
        goes straight to ``DONE`` — its output is complete on disk; no
        engine needs to run.

        Idempotent: gids already in the fleet table are skipped, so
        running ``recover`` twice (or recovering into a router that
        already re-submitted some requests) changes nothing."""
        if journal is not None:
            self.journal = journal
        if self.journal is None:
            raise ValueError("Router.recover: no journal attached")
        st = self.journal.state
        self._next_gid = max(self._next_gid, st.next_gid)
        info = {"n_live": st.n_live, "n_recovered": 0, "n_done": 0,
                "n_placed": 0, "n_pending": 0, "n_failed": 0,
                "n_skipped": 0}
        for gid in sorted(st.live):
            if gid in self._reqs:
                info["n_skipped"] += 1     # idempotence: already rebuilt
                continue
            rec = st.live[gid]
            fr = FleetRequest(
                gid=gid, prompt=np.asarray(rec["prompt"], np.int32),
                max_new_tokens=rec["max_new_tokens"],
                eos_id=rec["eos_id"],
                deadline_steps=rec["deadline_steps"],
                tokens=list(rec["tokens"]),
                migrations=rec.get("migrations", 0))
            self._reqs[gid] = fr
            self._journal_recovered.append(gid)
            info["n_recovered"] += 1
            self._event("recover", gid=gid, emitted=len(fr.tokens))
            if self.tracer is not None:
                # recovered requests get a fresh root span (the crashed
                # router's span died open with it); replay=True marks the
                # timeline as a post-recovery continuation
                fr.span_ids["fleet_req"] = self.tracer.begin(
                    "fleet_req", trace=fr.gid, prompt_len=len(fr.prompt),
                    max_new_tokens=fr.max_new_tokens, replay=True,
                    emitted=len(fr.tokens))
                fr.span_ids["recover"] = self.tracer.begin(
                    "recover", trace=fr.gid,
                    parent=fr.span_ids["fleet_req"],
                    emitted=len(fr.tokens))
            if len(fr.tokens) >= fr.max_new_tokens:
                # complete on disk — the engine would (rightly) reject
                # an emitted prefix that leaves nothing to generate
                self._fleet_terminal(fr, DONE, tokens=len(fr.tokens),
                                     recovered=True)
                self._recovered_done += 1
                info["n_done"] += 1
                continue
            try:
                # front=False in ascending-gid order into empty queues:
                # recovery REBUILDS the FCFS order (front=True would
                # reverse it)
                placed = self._place(fr, front=False)
            except ValueError:
                self._fleet_terminal(fr, FAILED,
                                     reason="replay prompt exceeds buckets")
                info["n_failed"] += 1
                continue
            if placed:
                if self.tracer is not None:
                    self.tracer.end(fr.span_ids.pop("recover", None),
                                    replica=fr.replica)
                info["n_placed"] += 1
            else:
                self._pending.append(fr)
                info["n_pending"] += 1
        return info

    # -- the breaker -------------------------------------------------------
    def _update_health(self, i: int) -> None:
        b, marks = self.breaker, self._fault_marks[i]
        e = self.engines[i]
        # new faults since last look -> timestamped marks in the window
        new = e.metrics.faults - self._fault_seen[i]
        self._fault_seen[i] = e.metrics.faults
        for _ in range(new):
            marks.append(self._step_no)
        while marks and marks[0] <= self._step_no - b.window_steps:
            marks.popleft()
        # stall detector: residents but no progress.  A dead subprocess
        # worker (SIGKILL — its RPC heartbeat stopped and the proxy
        # marked itself dead) holding ANY work counts as stalled too:
        # its token counter froze at death, so queued-only work would
        # otherwise never trip the resident-based detector.
        alive = getattr(e, "alive", True)
        progressed = e.metrics.tokens_emitted > self._tokens_seen[i]
        self._tokens_seen[i] = e.metrics.tokens_emitted
        holding = e.scheduler.resident > 0 or e.scheduler.queue_depth > 0
        if (e.scheduler.resident > 0 and not progressed) \
                or (not alive and holding):
            self._stalled[i] += 1
        else:
            self._stalled[i] = 0

        h = self.health[i]
        if h == QUARANTINED:
            self.time_in_quarantine[i] += 1
            if not alive:
                # a dead process never earns probation — the quarantine
                # was the breaker noticing the SIGKILL; finalize it
                self._set_health(i, DEAD, "process dead in quarantine")
                return
            if (self._step_no - self._quarantined_at[i]
                    >= b.cooldown_steps):
                marks.clear()
                self._stalled[i] = 0
                self._set_health(i, DEGRADED, "cooldown over (probation)")
            return
        if h == DRAINING:
            if not self.engines[i].scheduler.has_work():
                self._set_health(i, DRAINED, "drained")
            return
        if h not in ACCEPTING:
            return
        if len(marks) >= b.quarantine_faults \
                or self._stalled[i] >= b.stall_steps:
            why = ("fault budget" if len(marks) >= b.quarantine_faults
                   else f"stalled {self._stalled[i]} steps")
            self._set_health(i, QUARANTINED, why)
            self._quarantined_at[i] = self._step_no
            self._paused[i] = 0
            self._evacuate(i, f"replica {i} quarantined ({why})")
        elif h == HEALTHY and len(marks) >= b.degrade_faults:
            self._set_health(i, DEGRADED, "fault in window")
        elif h == DEGRADED and not marks and self._stalled[i] == 0:
            self._set_health(i, HEALTHY, "window clean")

    # -- the step loop -----------------------------------------------------
    def _harvest(self, i: int) -> None:
        """Mirror emitted tokens and resolve locally-terminal requests
        into fleet outcomes."""
        eng = self.engines[i]
        for rid, gid in list(self._local2gid[i].items()):
            req = eng._requests[rid]
            fr = self._reqs[gid]
            if self.journal is not None:
                # journal the healthy token DELTA before mirroring it:
                # the start index makes post-recovery re-emission an
                # idempotent splice, not a double-append.  The durable
                # length is the REDUCER's view (not fr.tokens — the
                # cadence below lets the mirror run ahead of the WAL)
                rec = self.journal.state.live.get(gid)
                jlen = len(rec["tokens"]) if rec is not None else None
                due = (req.state in TERMINAL
                       or self._step_no % self.journal_tokens_every == 0)
                if jlen is not None and due and len(req.tokens) > jlen:
                    self.journal.tokens(gid, jlen, req.tokens[jlen:])
            fr.tokens = list(req.tokens)   # the replicated request log
            if req.state not in TERMINAL:
                continue
            self._local2gid[i].pop(rid, None)
            fr.replica, fr.local_rid = None, None
            if req.state == DONE:
                self._fleet_terminal(fr, DONE, tokens=len(fr.tokens))
            elif req.state in (CANCELLED, DROPPED):
                # deadline shedding and engine-side cancels are FINAL —
                # a request that timed out queueing does not get a
                # second queue on another replica
                self._fleet_terminal(fr, req.state)
            elif req.state == FAILED:
                # local retry budget exhausted: one fleet-level failover
                self._migrate(fr, f"replica {i} FAILED rid {rid}")
            # MIGRATED locals are resolved at the evacuation site

    def step(self) -> None:
        """One fleet step: chaos hook, step live replicas, harvest
        outcomes, update breakers, retry pending migrations."""
        hook = self.hooks.get("pre_step")
        if hook is not None:
            hook(self)
        for i, eng in enumerate(self.engines):
            if self.health[i] in (DEAD, QUARANTINED, DRAINED):
                continue
            if self._paused[i] > 0:
                self._paused[i] -= 1
            elif eng.scheduler.has_work():
                eng.step()
            self._harvest(i)
        for i in range(len(self.engines)):
            if self.health[i] != DEAD:
                self._update_health(i)
        for _ in range(len(self._pending)):
            fr = self._pending.popleft()
            if fr.state in TERMINAL:
                continue
            try:
                placed = self._place(fr, front=True)
            except ValueError:
                self._fleet_terminal(fr, FAILED,
                                     reason="replay prompt exceeds buckets")
                continue
            if placed:
                fr.migrations += 1
                self.registry.inc("fleet.migrations")
                if self.tracer is not None:
                    self.tracer.end(fr.span_ids.pop("migrate", None),
                                    replica=fr.replica)
                    self.tracer.end(fr.span_ids.pop("recover", None),
                                    replica=fr.replica)
            else:
                self._pending.append(fr)
        self._step_no += 1

    def live_requests(self) -> int:
        return sum(1 for fr in self._reqs.values()
                   if fr.state not in TERMINAL)

    def run(self, trace: Sequence[TraceRequest], *,
            max_steps: Optional[int] = None) -> dict:
        """Drive a step-indexed trace through the fleet (same contract
        as ``ServeEngine.run``: backpressured submits are shed and
        counted; a stuck fleet returns a summary flagged ``stalled``)."""
        pending = sorted(trace, key=lambda r: r.arrival_step)
        i = 0
        budget = max_steps if max_steps is not None else (
            sum((r.max_new_tokens + 4) * (self.max_migrations + 2)
                for r in pending)
            # recovered/in-flight requests already in the fleet table
            # (e.g. rebuilt by recover() before an empty post-crash
            # trace) need step budget too, or the drain is misflagged
            # as a stall
            + sum((fr.max_new_tokens - len(fr.tokens) + 4)
                  * (self.max_migrations + 2)
                  for fr in self._reqs.values()
                  if fr.state not in TERMINAL)
            + (pending[-1].arrival_step if pending else 0) + 32)
        while i < len(pending) or self.live_requests() > 0:
            while (i < len(pending)
                   and pending[i].arrival_step <= self._step_no):
                r = pending[i]
                try:
                    self.submit(r.prompt, r.max_new_tokens)
                except AdmissionRejected:
                    pass                  # fleet backpressure: counted
                i += 1
            if self.live_requests() == 0 and i < len(pending):
                self._step_no = pending[i].arrival_step
                continue
            self.step()
            budget -= 1
            if budget < 0:
                return self.summary(stalled=True)
        return self.summary()

    # -- accounting --------------------------------------------------------
    def request(self, gid: int) -> FleetRequest:
        return self._reqs[gid]

    def reconcile(self) -> dict:
        """Cross-check the fleet request table against every replica
        ledger.  Every placement must be terminal on exactly one
        replica (or still live), and the per-replica DONE/MIGRATED
        counts must sum to the fleet's."""
        per = [e.summary() for e in self.engines]
        fleet_done = sum(1 for fr in self._reqs.values()
                         if fr.state == DONE)
        fleet_failed = sum(1 for fr in self._reqs.values()
                           if fr.state == FAILED)
        local_done = sum(s["n_done"] for s in per)
        local_migrated = sum(s["n_migrated_out"] for s in per)
        placements = sum(len(fr.placements) for fr in self._reqs.values())
        local_requests = sum(s["n_requests"] for s in per)
        # a placement ends in exactly one local terminal state or is live
        live = self.live_requests() - len(self._pending)
        local_terminal = sum(
            s["n_done"] + s["n_cancelled"] + s["n_dropped"]
            + s["n_failed"] + s["n_migrated_out"] for s in per)
        checks = {
            # recovered-complete requests go DONE straight from the
            # journal, with no local placement to match
            "done_matches":
                fleet_done == local_done + self._recovered_done,
            "placements_match": placements == local_requests,
            "terminals_match": local_terminal == placements - live,
            "migrations_bounded": self.migrations <= local_migrated,
            "failed_bounded":
                fleet_failed <= sum(s["n_failed"] for s in per)
                + self.failovers,
        }
        out = {"fleet_done": fleet_done, "local_done": local_done,
               "placements": placements, "local_requests": local_requests,
               "local_terminal": local_terminal, "live": live}
        if self.journal is not None:
            # the durability half: every journaled SUBMIT is either
            # still live or reached EXACTLY ONE terminal record
            st = self.journal.state
            checks["journal_accounted"] = (
                st.duplicate_terminals == 0
                and st.n_submits == st.n_terminals + st.n_live)
            out["journal"] = {
                "n_submits": st.n_submits,
                "n_terminals": st.n_terminals,
                "n_live": st.n_live,
                "duplicate_terminals": st.duplicate_terminals,
                "terminal_counts": dict(st.terminal_counts),
                "appends": self.journal.appends,
                "snapshots": self.journal.snapshots,
            }
        out.update(ok=all(checks.values()), checks=checks)
        return out

    def summary(self, *, stalled: bool = False) -> dict:
        """Fleet metrics: per-replica summaries rolled up via
        ``fleet_summary`` plus the router's own ledger (failovers,
        migrations, replay success, health, reconciliation)."""
        per = [e.summary() for e in self.engines]
        out = fleet_summary(per)
        by_state = {s: sum(1 for fr in self._reqs.values()
                           if fr.state == s)
                    for s in (DONE, CANCELLED, DROPPED, FAILED)}
        migrated = [fr for fr in self._reqs.values() if fr.migrations > 0]
        out["fleet"] = {
            "n_requests": len(self._reqs),
            "n_done": by_state[DONE],
            "n_cancelled": by_state[CANCELLED],
            "n_dropped": by_state[DROPPED],
            "n_failed": by_state[FAILED],
            "n_live": self.live_requests(),
            "n_pending_migration": len(self._pending),
            "n_rejected": self.rejected,
            "failovers": self.failovers,
            "n_migrations": self.migrations,
            "n_migrated_requests": len(migrated),
            # of the requests that had to move replicas, how many still
            # finished — the fleet replay path's success rate
            "replay_success_rate": (
                sum(1 for fr in migrated if fr.state == DONE)
                / len(migrated) if migrated else 1.0),
            "goodput_tokens": sum(len(fr.tokens)
                                  for fr in self._reqs.values()
                                  if fr.state == DONE),
            "n_recovered": len(self._journal_recovered),
            # of the requests recover() rebuilt from the journal, how
            # many reached DONE — the crash-recovery success rate the
            # CI ratchet floors
            "recovery_replay_success": (
                sum(1 for g in self._journal_recovered
                    if self._reqs[g].state == DONE)
                / len(self._journal_recovered)
                if self._journal_recovered else 1.0),
        }
        out["health"] = list(self.health)
        out["time_in_quarantine"] = list(self.time_in_quarantine)
        out["stalled"] = stalled
        out["step_no"] = self._step_no
        out["reconcile"] = self.reconcile()
        return out


def make_fleet(build_engine: Callable[[int], object], n_replicas: int,
               **router_kwargs) -> Router:
    """Build + warm ``n_replicas`` engines (``build_engine(i)`` must
    return an UNwarmed ServeEngine; warmup happens here so the router
    only ever sees warmed replicas) and front them with a Router."""
    engines = []
    for i in range(n_replicas):
        e = build_engine(i)
        e.warmup()
        engines.append(e)
    return Router(engines, **router_kwargs)
