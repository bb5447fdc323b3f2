"""Request-scoped tracing (a copy of ``repro.obs.trace``): span_begin /
span_end records on the event stream, reconstructed into timelines by
``tools/tracelens.py``.

A span is two events sharing an ``sid``:

    span_begin  name, sid, trace, parent, pid, ts, **attrs
    span_end    sid, ts, **attrs

``ts`` is ``time.perf_counter()`` — monotonic, comparable across every
tracer in one process (the fleet tests run replicas in-process for
exactly this reason).  ``trace`` is the request identity the span
belongs to: the engine uses ``key_id or rid``, the router uses ``gid``,
and because migrated/recovered requests keep their gid the whole
lifetime stitches together across replicas.  Both halves are emitted
(not one folded "complete" record) so a crash leaves the open spans
visible in the stream — an unclosed ``decode`` span after kill -9 is
the observation, not a bug.

Every call site guards ``if tracer is not None`` (or goes through
:func:`maybe_span`) so the traced-off path costs nothing.
"""
from __future__ import annotations

import itertools
import os
import time
from contextlib import contextmanager, nullcontext

from repro_torch.obs.schema import SPAN_NAMES

#: per-process tracer instance counter: two tracers with the same pid
#: label (e.g. a restarted "router" appending to the same event file)
#: must never reuse span ids, or the new run's span_end records would
#: pair against the crashed run's still-open begins
_INSTANCES = itertools.count()


class Tracer:
    """Emits span records for one process/component to an EventSink.

    ``pid`` namespaces the span ids (and becomes the Perfetto process
    lane), so multiple tracers can share one sink: the router traces as
    ``router``, replica ``i`` as ``r{i}``, the journal as ``journal``.
    """

    def __init__(self, sink, *, pid: str = "main",
                 clock=time.perf_counter) -> None:
        self.sink = sink
        self.pid = pid
        self.clock = clock
        self._ns = f"{os.getpid()}.{next(_INSTANCES)}"
        self._n = 0

    def begin(self, name: str, *, trace=None, parent=None, **attrs) -> str:
        if name not in SPAN_NAMES:
            raise ValueError(f"undeclared span name {name!r}; add it to "
                             f"repro_torch.obs.schema.SPAN_NAMES")
        self._n += 1
        sid = f"{self.pid}:{self._ns}:{self._n}"
        self.sink.emit("span_begin", name=name, sid=sid, trace=trace,
                       parent=parent, pid=self.pid, ts=self.clock(),
                       **attrs)
        return sid

    def end(self, sid, **attrs) -> None:
        if sid is None:          # begin was skipped (tracer attached late)
            return
        self.sink.emit("span_end", sid=sid, ts=self.clock(), **attrs)

    @contextmanager
    def span(self, name: str, *, trace=None, parent=None, **attrs):
        sid = self.begin(name, trace=trace, parent=parent, **attrs)
        try:
            yield sid
        finally:
            self.end(sid)


def maybe_span(tracer, name: str, **kw):
    """``with maybe_span(self.tracer, "step"):`` — a no-op context when
    tracing is off, so call sites stay one line."""
    if tracer is None:
        return nullcontext()
    return tracer.span(name, **kw)
