"""Streaming metrics registry: counters, gauges, and bounded-memory
histograms whose snapshots merge exactly across the worker RPC boundary.

Design constraints (ISSUE 10):

* **Bounded memory.**  A histogram is a sparse dict of log2 buckets plus
  exact ``n/sum/min/max`` — O(number of distinct magnitudes), never
  O(samples).  ``ServeMetrics`` retires per-request stats into these at
  terminal time, so a long-running router holds O(live) metric state.
* **Exact merges.**  Fixed log2 buckets (unlike P²/t-digest centroids)
  merge by elementwise count addition, which is commutative AND
  associative — ``merge(a, b) == merge(b, a)`` holds bit-for-bit, so the
  router can fold per-replica RPC snapshots in any arrival order.
* **Plain-JSON snapshots.**  ``snapshot()`` returns nothing but dicts,
  strings, ints and floats: it pickles across the worker pipe, survives
  a round-trip through the JSONL event stream (``metrics_snapshot``
  events), and merges on either side of the boundary.

Means are exact (``sum / n``); quantiles interpolate inside a bucket and
are clamped to the observed ``[min, max]`` — a log2 bucket bounds the
relative quantile error at 2x, plenty for latency breakdowns.
"""
from __future__ import annotations

import math
import threading

# log2 bucket span: bucket e covers [2^(e-1), 2^e).  Clamp keeps the
# vocabulary finite for adversarial values (denormals, +inf).
_E_MIN, _E_MAX = -30, 33
_ZERO = _E_MIN - 1          # bucket for v <= 0


def _bucket(v: float) -> int:
    if not v > 0.0 or math.isinf(v):
        return _ZERO if not v > 0.0 else _E_MAX
    return min(max(math.frexp(v)[1], _E_MIN), _E_MAX)


def _bucket_hi(e: int) -> float:
    return 0.0 if e == _ZERO else 2.0 ** e


def _bucket_lo(e: int) -> float:
    return 0.0 if e <= _E_MIN else 2.0 ** (e - 1)


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins sample; ``updates`` orders merges deterministically."""
    __slots__ = ("value", "updates")

    def __init__(self) -> None:
        self.value = 0.0
        self.updates = 0

    def set(self, v: float) -> None:
        self.value = float(v)
        self.updates += 1


class Histogram:
    """Sparse log2-bucket streaming histogram with exact n/sum/min/max."""
    __slots__ = ("n", "sum", "min", "max", "counts")

    def __init__(self) -> None:
        self.n = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.counts: dict = {}

    def observe(self, v: float) -> None:
        v = float(v)
        self.n += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        e = _bucket(v)
        self.counts[e] = self.counts.get(e, 0) + 1

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def quantile(self, q: float) -> float:
        if not self.n:
            return 0.0
        rank = q * (self.n - 1)
        seen = 0
        for e in sorted(self.counts):
            c = self.counts[e]
            if seen + c > rank:
                lo, hi = _bucket_lo(e), _bucket_hi(e)
                frac = (rank - seen + 1) / c          # position in bucket
                v = lo + (hi - lo) * min(frac, 1.0)
                return min(max(v, self.min), self.max)
            seen += c
        return self.max

    def to_dict(self) -> dict:
        return {"n": self.n, "sum": self.sum,
                "min": self.min if self.n else 0.0,
                "max": self.max if self.n else 0.0,
                "counts": {str(e): c for e, c in sorted(self.counts.items())}}


def hist_quantile(h: dict, q: float) -> float:
    """Quantile straight off a histogram *snapshot* dict."""
    n = h.get("n", 0)
    if not n:
        return 0.0
    rank = q * (n - 1)
    seen = 0
    for e in sorted(int(k) for k in h["counts"]):
        c = h["counts"][str(e)]
        if seen + c > rank:
            lo, hi = _bucket_lo(e), _bucket_hi(e)
            v = lo + (hi - lo) * min((rank - seen + 1) / c, 1.0)
            return min(max(v, h["min"]), h["max"])
        seen += c
    return h["max"]


class MetricsRegistry:
    """Create-on-demand named counters/gauges/histograms with JSON
    snapshots and an exact, order-independent snapshot merge."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}

    # --- create-on-demand accessors ----------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            return h

    # --- conveniences -------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    def count(self, name: str) -> int:
        return self._counters[name].value if name in self._counters else 0

    # --- snapshots -----------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: {"value": g.value, "updates": g.updates}
                           for k, g in self._gauges.items()},
                "hists": {k: h.to_dict() for k, h in self._hists.items()},
            }

    @staticmethod
    def merge(a: dict, b: dict) -> dict:
        """Merge two snapshot dicts.  Commutative and associative:
        counters/hist-counts add, gauges keep the sample with the most
        updates (value breaks ties), min/max fold through min/max."""
        out = {"counters": dict(a.get("counters", {})),
               "gauges": {k: dict(v)
                          for k, v in a.get("gauges", {}).items()},
               "hists": {k: {**v, "counts": dict(v["counts"])}
                         for k, v in a.get("hists", {}).items()}}
        for k, v in b.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0) + v
        for k, g in b.get("gauges", {}).items():
            cur = out["gauges"].get(k)
            # max on (updates, value): a deterministic, order-independent
            # winner even though gauges are last-write-wins in spirit
            if cur is None or (g["updates"], g["value"]) > \
                    (cur["updates"], cur["value"]):
                out["gauges"][k] = dict(g)
        for k, h in b.get("hists", {}).items():
            cur = out["hists"].get(k)
            if cur is None:
                out["hists"][k] = {**h, "counts": dict(h["counts"])}
                continue
            # empty snapshots carry min=max=0.0 placeholders; only fold
            # extrema from sides that actually observed samples
            if not cur["n"]:
                cur["min"], cur["max"] = h["min"], h["max"]
            elif h["n"]:
                cur["min"] = min(cur["min"], h["min"])
                cur["max"] = max(cur["max"], h["max"])
            cur["n"] += h["n"]
            cur["sum"] += h["sum"]
            for e, c in h["counts"].items():
                cur["counts"][e] = cur["counts"].get(e, 0) + c
        return out

    def emit(self, sink, **extra) -> None:
        """Write a ``metrics_snapshot`` event to an EventSink."""
        if sink is not None:
            sink.emit("metrics_snapshot", snapshot=self.snapshot(), **extra)
