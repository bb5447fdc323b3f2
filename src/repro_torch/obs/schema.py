"""The single registry of event kinds and span names (a copy of
``repro.obs.schema``, whose kinds and names it keeps unchanged, so
``tools/tracelens.py`` and the JAX package's ``validate_events`` read the
port's event files).

Every ``kind`` that can appear in a ``repro_torch.events`` JSONL stream
is declared here; :func:`undeclared_kinds_in_source` scans a source tree
for literal emit call sites and returns any kind that is not in
:data:`EVENT_KINDS`, so a new subsystem cannot quietly invent a private
vocabulary that ``tools/tracelens.py`` does not understand.  Span
*names* get the same treatment via :data:`SPAN_NAMES`: ``obs.trace.
Tracer`` refuses names that are not declared.
"""
from __future__ import annotations

import re

# kind -> one-line description (the contract tracelens + dashboards read)
EVENT_KINDS = {
    # --- serve metrics (ServeMetrics._event) -------------------------
    "terminal": "a request reached a terminal state (rid, state, tokens)",
    "reject": "admission rejected a submit (backpressure)",
    "fault": "decode sentinel tripped on a request (rid)",
    "retry": "a faulted request was requeued for replay (rid, attempt)",
    # --- train guards (TrainGuard._emit) -----------------------------
    "guard_skip": "guard skipped an update (reason, loss, streak)",
    "guard_rollback": "guard escalated to checkpoint rollback",
    "watchdog_alert": "a train step overran the watchdog budget",
    # --- router (Router._event) --------------------------------------
    "health": "replica health transition (replica, frm, to)",
    "place": "fleet request placed on a replica (gid, replica, rid)",
    "failover": "fleet request evacuated off a replica (gid, reason)",
    "fleet_terminal": "fleet request reached a terminal state (gid, state)",
    "fleet_reject": "every replica rejected a submit (gid)",
    "recover": "journal recovery re-submitted a live request (gid)",
    "pause": "chaos/operator paused a replica (replica, steps)",
    # --- write-ahead request journal (RequestJournal._append) --------
    "wal_submit": "WAL: request accepted by the fleet",
    "wal_place": "WAL: request placed on a replica",
    "wal_tokens": "WAL: durable token batch (gid, start, toks)",
    "wal_migrate": "WAL: request evacuated, will be re-placed",
    "wal_terminal": "WAL: request reached a terminal state",
    # --- observability plane (repro.obs) -----------------------------
    "span_begin": "trace span opened (name, sid, trace, parent, pid, ts)",
    "span_end": "trace span closed (sid, ts, + outcome attrs)",
    "metrics_snapshot": "periodic registry snapshot (counters/gauges/hists)",
    "mem_sample": "live-bytes sample scored against the plan budget",
}

# span name -> one-line description.  Segment classification in
# tools/tracelens.py keys off these names, so they are closed-world too.
SPAN_NAMES = {
    # engine / scheduler (trace = rid, or gid when key_id is set)
    "req": "whole request: submit -> terminal (root span)",
    "queue": "QUEUED: waiting for a slot (reason=submit|replay)",
    "prefill": "prompt prefill + scatter + first token",
    "decode": "DECODE residency: first token -> retirement",
    "step": "one engine step (admissions + fused decode + harvest)",
    # router (trace = gid)
    "fleet_req": "whole fleet request: fleet submit -> fleet terminal",
    "place": "placement attempt on a replica",
    "migrate": "evacuation -> successful re-placement elsewhere",
    "recover": "journal recovery replay of one live request",
    # infrastructure
    "rpc": "one worker RPC round-trip (op=...)",
    "journal_append": "one WAL append (+ group-commit fsync when due)",
    "journal_snapshot": "atomic .snap compaction",
    # train driver
    "data": "host data step: next(loader) + device put",
    "train_step": "jitted train step dispatch + loss sync",
    "guard": "guard verdict on the synced loss/grads",
    "checkpoint": "checkpoint save (or rollback restore)",
}


# literal emit callsites: EventSink.emit / the private wrappers every
# subsystem routes through (ServeMetrics._event, Router._event,
# RequestJournal._append, TrainGuard._emit, Tracer's own emits)
_EMIT_RE = re.compile(
    r"(?:\.emit|self\._event|self\._append|self\._emit)\(\s*"
    r"[\"']([a-z_]+)[\"']")


def undeclared_kinds_in_source(src_root: str):
    """Scan ``src_root`` for literal event-kind emit callsites and return
    ``{kind: [file:line, ...]}`` for any kind not in EVENT_KINDS."""
    import os

    bad: dict = {}
    for dirpath, _dirnames, filenames in os.walk(src_root):
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                for lineno, line in enumerate(f, 1):
                    for m in _EMIT_RE.finditer(line):
                        kind = m.group(1)
                        if kind not in EVENT_KINDS:
                            bad.setdefault(kind, []).append(
                                f"{path}:{lineno}")
    return bad


def validate_events(path: str):
    """Return the set of undeclared kinds found in an events file."""
    from repro_torch.events import read_events

    return {e["kind"] for e in read_events(path)} - set(EVENT_KINDS)
