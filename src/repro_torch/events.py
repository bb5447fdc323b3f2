"""Append-only JSONL event sink (a copy of ``repro.events``, which imports
no JAX): the metrics stream for long runs.

Counters kept in process memory die with the process.  Here every
producer (the training guards and watchdog, and in the JAX package also
the serve metrics and the fleet router) appends one JSON object per line
to a shared sink, so a multi-hour run leaves a replayable, greppable
record even if the process is later killed.

Design constraints:

* **append-only**: the file is opened in append mode and never seeked —
  two producers (e.g. a router and its replicas' metrics) can share one
  sink object; a crashed run's sink is still valid JSONL up to the last
  flushed line;
* **cheap on the hot path**: ``emit`` formats one dict and writes one
  line; ``flush_every`` batches the flush (default every line, because
  the whole point is surviving a crash).  A buffer flush survives a
  PROCESS crash but not a machine/kernel one — writers that need real
  durability (the serve request journal is one) pass ``fsync=True`` to
  force ``os.fsync`` on every flush;
* **monotonic sequence**: every event carries ``seq`` (per-sink
  counter) and ``t`` (wall clock) so interleaved producers can be
  ordered deterministically after the fact.  ``emit`` is thread-safe
  (the training watchdog alerts from its monitor thread while the main
  loop emits guard verdicts into the same sink).

``read_events`` is the consumer half: it tolerates a truncated final
line (a crash mid-write) by skipping it with a warning rather than
raising away the run's history.  With ``offset=`` it resumes from a
byte offset instead of re-reading the whole file, and with
``with_offset=True`` it returns ``(records, next_offset)`` where
``next_offset`` sits after the last COMPLETE line — an in-progress
torn tail is left for the next incremental read instead of being
skipped forever (the journal's tail-scan mode, and the live-monitor
mode: poll the file, keep only the new events).
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Optional, Union


class EventSink:
    """Append-only JSONL writer shared by every event producer."""

    def __init__(self, path: str, *, flush_every: int = 1,
                 fsync: bool = False, clock=time.time):
        if flush_every < 1:
            raise ValueError("EventSink: flush_every must be >= 1")
        self.path = path
        self._clock = clock
        self._flush_every = flush_every
        self._fsync = fsync
        self._file = open(path, "a")
        self._seq = 0
        self._unflushed = 0
        self._lock = threading.Lock()
        self.emitted = 0
        self.fsyncs = 0

    def _flush_locked(self) -> None:
        self._file.flush()
        if self._fsync:
            os.fsync(self._file.fileno())
            self.fsyncs += 1
        self._unflushed = 0

    def emit(self, kind: str, **fields) -> None:
        """Append one event.  ``kind`` names the event type; ``fields``
        must be JSON-serializable (producers pass plain ints/floats/str
        — device arrays must be pulled to host first)."""
        with self._lock:
            if self._file is None:
                raise RuntimeError(f"EventSink: {self.path} is closed")
            rec = {"seq": self._seq, "t": self._clock(), "kind": kind,
                   **fields}
            # compact separators: emit sits on serving/training hot paths
            # (span records fire every engine step when tracing is on),
            # and the default ", " spacing costs ~15% of the dump
            self._file.write(json.dumps(rec, separators=(",", ":")) + "\n")
            self._seq += 1
            self.emitted += 1
            self._unflushed += 1
            if self._unflushed >= self._flush_every:
                self._flush_locked()

    def flush(self) -> None:
        with self._lock:
            if self._file is not None:
                self._flush_locked()

    def tell(self) -> int:
        """Byte offset after the last WRITTEN record (flushes first) —
        the journal snapshots this so recovery can tail from here."""
        with self._lock:
            if self._file is None:
                raise RuntimeError(f"EventSink: {self.path} is closed")
            self._flush_locked()
            return self._file.tell()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._flush_locked()
                self._file.close()
                self._file = None

    def __enter__(self) -> "EventSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str, kind: Optional[str] = None, *,
                offset: int = 0, with_offset: bool = False
                ) -> Union[list[dict], tuple[list[dict], int]]:
    """Load a sink's events (optionally filtered by ``kind``).

    A truncated final line — a writer crashed mid-record — is skipped
    with a warning instead of poisoning the whole read.  ``offset``
    starts the scan at a byte offset (incremental tail reads: pass the
    ``next_offset`` a previous call returned).  With
    ``with_offset=True`` the return value is ``(records, next_offset)``
    and the torn tail is NOT warned about: the offset stops before it,
    so a still-in-flight write is simply retried by the next read —
    this is the mode a live consumer (or the journal's snapshot+tail
    recovery) uses under fsync batching, where a partial final line is
    the expected steady state, not a crash."""
    out: list[dict] = []
    with open(path, "rb") as f:
        if offset:
            f.seek(offset)
        data = f.read()
    end = offset                    # offset after the last COMPLETE line
    pos = 0
    while True:
        nl = data.find(b"\n", pos)
        if nl < 0:
            # incomplete trailing chunk: a torn (or in-flight) record
            if data[pos:].strip() and not with_offset:
                warnings.warn(f"read_events: {path} byte {offset + pos} "
                              f"is not valid JSON (truncated write?) — "
                              f"skipped")
            break
        line = data[pos:nl].strip()
        pos = nl + 1
        end = offset + pos
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            warnings.warn(f"read_events: {path} byte "
                          f"{offset + pos - len(line) - 1} is not valid "
                          f"JSON (truncated write?) — skipped")
            continue
        if kind is None or rec.get("kind") == kind:
            out.append(rec)
    if with_offset:
        return out, end
    return out
