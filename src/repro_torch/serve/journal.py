"""Write-ahead request journal (a port of ``repro.serve.journal``, which
writes the same records): the durable half of fleet serving.

The router survives a REPLICA kill because it mirrors every healthy
token in process memory — but that mirror dies with the router.  This
module is the replicated request log: every fleet-visible request
transition is appended (fsync'd) to a
JSONL journal BEFORE the in-memory state changes, so after a
whole-router ``kill -9`` the fleet can be rebuilt from disk and every
in-flight request replayed from its prompt + durably-logged tokens —
OpTorch's sequential-checkpoint principle (persist minimal state,
recompute the rest) applied to the serving control plane.

Record schema (one JSONL record per append, on ``repro_torch.events``;
the same kinds and fields as the JAX package's, so a journal written by
either package loads in the other):

``wal_submit``   gid, prompt, max_new_tokens, eos_id, deadline_steps —
                 appended BEFORE placement, so a crash between append
                 and placement still recovers the request.
``wal_place``    gid, replica, rid, front, emitted — informational
                 (placement is rebuilt at recovery, not replayed).
``wal_tokens``   gid, start, toks — the per-step HEALTHY token deltas
                 (``tokens[start:start+len(toks)] = toks``; the start
                 index makes re-emission after a recovery idempotent).
``wal_migrate``  gid, reason — informational failover marker.
``wal_terminal`` gid, state, n_tokens — exactly one per submit; a
                 second terminal for the same gid is counted as a
                 ``duplicate_terminal`` and fails ``Router.reconcile``.

Durability contract: with ``fsync=True`` (the default) every append is
``os.fsync``'d, so a token the journal returned from ``tokens()`` is
never lost.  Tokens generated after the last durable record — the
fsync-lag window under ``flush_every > 1``, or the torn final record of
a crash — are NOT restored: recovery re-submits the request with the
durable prefix and the engine REGENERATES them (token-exact under
greedy decode, key-exact under ``sampler_keys="request"`` sampling).

Snapshot + compaction: ``snapshot()`` atomically writes ``path +
".snap"`` holding the reduced :class:`JournalState` (live requests +
terminal COUNTS — O(live), not O(history)) plus the byte offset it
covers.  Recovery (:func:`load_state`) loads the snapshot and tails
only the records after its offset via ``read_events(offset=)``, so
recovery cost is proportional to the live request set no matter how
long the journal has been running.  The journal file itself stays
append-only (crash-safe by construction); the snapshot is the
compaction.

A fleet served over a mesh runs one router on every rank, and only one
rank writes the journal: the others hold a :meth:`RequestJournal.mirror`
of it, built from the writer's state (broadcast when the journal is
opened), which reduces the same appends in memory and writes nothing, so
every rank's router reads the same durable token counts.

``hooks["post_append"]`` is the crash-at-every-point seam: the fault
harness (``serve/faults.py``) installs a hook that raises
:class:`~repro_torch.serve.faults.SimulatedCrash` after the N-th append —
AFTER the record hit disk, BEFORE the router acted on it — which is
exactly the "kill -9 between journal append and placement" window.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

from repro_torch.events import EventSink, read_events

#: journal record kinds (the ``kind`` field of each JSONL record)
WAL_KINDS = ("wal_submit", "wal_place", "wal_tokens", "wal_migrate",
             "wal_terminal")


@dataclasses.dataclass
class JournalState:
    """The reduction of a journal: what recovery needs, nothing more.

    ``live`` maps gid -> the request's durable record (prompt, budget,
    tokens so far); terminals are kept as COUNTS per state (plus the
    goodput token sum), so the state stays O(live requests) and a
    snapshot of it compacts arbitrarily long history."""
    next_gid: int = 0
    n_submits: int = 0
    n_terminals: int = 0
    duplicate_terminals: int = 0
    goodput_tokens: int = 0               # tokens of DONE requests
    terminal_counts: dict = dataclasses.field(default_factory=dict)
    live: dict = dataclasses.field(default_factory=dict)

    @property
    def n_live(self) -> int:
        return len(self.live)

    def apply(self, kind: str, rec: dict) -> None:
        """Fold one journal record into the state (the same reducer runs
        at append time and at recovery time, so the two can never
        disagree)."""
        gid = rec["gid"]
        if kind == "wal_submit":
            self.live[gid] = {
                "prompt": list(rec["prompt"]),
                "max_new_tokens": rec["max_new_tokens"],
                "eos_id": rec["eos_id"],
                "deadline_steps": rec["deadline_steps"],
                "tokens": [], "migrations": 0, "placements": 0,
            }
            self.n_submits += 1
            self.next_gid = max(self.next_gid, gid + 1)
        elif kind == "wal_place":
            r = self.live.get(gid)
            if r is not None:
                r["placements"] += 1
        elif kind == "wal_tokens":
            r = self.live.get(gid)
            if r is not None:
                start, toks = rec["start"], list(rec["toks"])
                # start-indexed splice: a re-emission after recovery
                # overwrites the regenerated overlap instead of
                # double-appending (the streams agree by determinism)
                r["tokens"] = r["tokens"][:start] + toks
        elif kind == "wal_migrate":
            r = self.live.get(gid)
            if r is not None:
                r["migrations"] += 1
        elif kind == "wal_terminal":
            r = self.live.pop(gid, None)
            if r is None:
                self.duplicate_terminals += 1
                return
            state = rec["state"]
            self.n_terminals += 1
            self.terminal_counts[state] = \
                self.terminal_counts.get(state, 0) + 1
            if state == "DONE":
                self.goodput_tokens += rec.get("n_tokens", 0)

    def to_json(self) -> dict:
        return {"next_gid": self.next_gid, "n_submits": self.n_submits,
                "n_terminals": self.n_terminals,
                "duplicate_terminals": self.duplicate_terminals,
                "goodput_tokens": self.goodput_tokens,
                "terminal_counts": dict(self.terminal_counts),
                "live": {str(g): r for g, r in self.live.items()}}

    @classmethod
    def from_json(cls, d: dict) -> "JournalState":
        return cls(next_gid=d["next_gid"], n_submits=d["n_submits"],
                   n_terminals=d["n_terminals"],
                   duplicate_terminals=d["duplicate_terminals"],
                   goodput_tokens=d["goodput_tokens"],
                   terminal_counts=dict(d["terminal_counts"]),
                   live={int(g): r for g, r in d["live"].items()})


def load_state(path: str) -> tuple[JournalState, int]:
    """Recover a journal's state from disk: snapshot (if any) + tail.

    Returns ``(state, next_offset)``.  Tolerates a torn final record
    (``read_events`` tail mode stops before it) and a missing/stale
    snapshot (falls back to a full-history scan — same reducer, same
    state, just O(history) instead of O(live))."""
    state, offset = JournalState(), 0
    snap = path + ".snap"
    if os.path.exists(snap):
        try:
            with open(snap) as f:
                d = json.load(f)
            state = JournalState.from_json(d["state"])
            offset = d["offset"]
        except (json.JSONDecodeError, KeyError):
            # half-written snapshot (crash mid-rename is impossible —
            # the write is atomic — but a hand-torn file is not): fall
            # back to the full scan
            state, offset = JournalState(), 0
    recs, end = read_events(path, offset=offset, with_offset=True)
    for rec in recs:
        if rec.get("kind") in WAL_KINDS:
            state.apply(rec["kind"], rec)
    return state, end


class RequestJournal:
    """Fsync'd write-ahead journal of fleet request transitions.

    Opening an existing journal REPLAYS it (snapshot + tail) into
    ``self.state`` and then appends — the restart path.  ``state`` is
    maintained incrementally on every append, so ``Router.reconcile``
    can cross-check the fleet table against the journal at any time
    without re-reading the file.
    """

    def __init__(self, path: str | None, *, fsync: bool = True,
                 flush_every: int = 1, snapshot_every: int = 0,
                 state: JournalState | None = None):
        if snapshot_every < 0:
            raise ValueError("RequestJournal: snapshot_every must be >= 0")
        self.path = path
        self.snapshot_every = snapshot_every
        if path is None:                        # a mirror: no file
            self.state, self._sink = state or JournalState(), None
        else:
            self.state, _ = load_state(path) if os.path.exists(path) \
                else (JournalState(), 0)
            self._sink = EventSink(path, fsync=fsync,
                                   flush_every=flush_every)
        self.appends = 0
        self.snapshots = 0
        #: crash-at-every-point seam: fn(journal, kind, rec), called
        #: AFTER the record is durable and reduced into ``state``
        self.hooks: dict[str, Callable] = {}
        #: optional repro_torch.obs Tracer: every append (and its group-commit
        #: fsync) becomes a ``journal_append`` span on the event stream,
        #: so WAL latency shows up in the same timeline as the requests
        #: paying for it
        self.tracer = None

    @classmethod
    def mirror(cls, state: JournalState, *,
               snapshot_every: int = 0) -> "RequestJournal":
        """A journal that writes nothing: ``state`` (the writer's, as it
        was opened) reduced by the same appends, in memory.  Its appends,
        snapshots and ``post_append`` hook count as the writer's do."""
        return cls(None, snapshot_every=snapshot_every, state=state)

    # -- append side -------------------------------------------------------
    def _append(self, kind: str, **fields) -> None:
        if self._sink is not None and self.tracer is not None:
            with self.tracer.span("journal_append", trace=fields.get("gid"),
                                  wal=kind):
                self._sink.emit(kind, **fields)
        elif self._sink is not None:
            self._sink.emit(kind, **fields)
        self.state.apply(kind, fields)
        self.appends += 1
        hook = self.hooks.get("post_append")
        if hook is not None:
            hook(self, kind, fields)
        if self.snapshot_every and self.appends % self.snapshot_every == 0:
            self.snapshot()

    def submit(self, gid: int, prompt, max_new_tokens: int,
               eos_id: Optional[int], deadline_steps: Optional[int]) -> None:
        self._append("wal_submit", gid=gid,
                     prompt=[int(t) for t in prompt],
                     max_new_tokens=int(max_new_tokens),
                     eos_id=None if eos_id is None else int(eos_id),
                     deadline_steps=(None if deadline_steps is None
                                     else int(deadline_steps)))

    def place(self, gid: int, replica: int, rid: int, *,
              front: bool, emitted: int) -> None:
        self._append("wal_place", gid=gid, replica=replica, rid=rid,
                     front=front, emitted=emitted)

    def tokens(self, gid: int, start: int, toks) -> None:
        self._append("wal_tokens", gid=gid, start=int(start),
                     toks=[int(t) for t in toks])

    def migrate(self, gid: int, reason: str) -> None:
        self._append("wal_migrate", gid=gid, reason=reason)

    def terminal(self, gid: int, state: str, n_tokens: int = 0) -> None:
        self._append("wal_terminal", gid=gid, state=state,
                     n_tokens=int(n_tokens))

    # -- compaction --------------------------------------------------------
    def snapshot(self) -> str:
        """Atomically write the compaction snapshot (state + covered
        offset) to ``path + ".snap"``.  Recovery after this point reads
        the snapshot plus only the journal tail."""
        if self._sink is None:                  # a mirror writes nothing
            self.snapshots += 1
            return ""
        sid = None if self.tracer is None else \
            self.tracer.begin("journal_snapshot", live=self.state.n_live)
        offset = self._sink.tell()
        tmp = self.path + ".snap.tmp"
        with open(tmp, "w") as f:
            json.dump({"offset": offset, "state": self.state.to_json()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path + ".snap")
        self.snapshots += 1
        if self.tracer is not None:
            self.tracer.end(sid, offset=offset)
        return self.path + ".snap"

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
