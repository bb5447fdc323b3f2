"""Checkpoint-placement solvers, the paper's Fig. 11 advice as
optimisation (a copy of ``repro.plan.solver``, which imports no JAX, held
to equal output by the tests).

Peak training memory under sequential checkpoints (S-C) is modelled as

    peak = sum(stored checkpoint activations) + max over segments of the
           segment's internal live set,

following Chen et al. (sublinear memory cost) and Beaumont et al.
(optimal checkpointing for heterogeneous chains).  Two solvers:

  * ``min_peak_boundaries``: given a checkpoint *count* k, place the k
    boundaries minimising peak bytes;
  * ``budget_boundaries``: given a byte *budget*, minimise recompute FLOPs
    subject to ``peak <= budget`` (the earliest feasible last boundary).

Both feed a :class:`RematPlan`: where to cut a layer chain into
sequential-checkpoint segments, and with which policy.  A plan the JAX
package's solvers wrote (``RematPlan.save``) loads here unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class RematPlan:
    """Where to cut a layer chain into remat segments.

    n_layers:    length of the chain the plan was solved for (validated at
                 application time — a plan never silently applies to a
                 different depth).
    boundaries:  sorted interior checkpoint sites b (0 < b < n_layers);
                 segment j spans layers [b_{j-1}, b_j).
    policy:      a single policy name for every segment, or one name per
                 segment (len == n_segments) for heterogeneous plans.
    source:      provenance string ("uniform", "min_peak:k=3",
                 "budget:128MiB", ...) for logs and reproducibility.
    """

    n_layers: int
    boundaries: tuple[int, ...] = ()
    policy: "str | tuple[str, ...]" = "full"
    source: str = ""

    def __post_init__(self):
        b = tuple(sorted(int(x) for x in self.boundaries))
        if len(set(b)) != len(b):
            raise ValueError(f"duplicate plan boundaries {b}")
        if b and not (0 < b[0] and b[-1] < self.n_layers):
            raise ValueError(
                f"plan boundaries {b} out of range for {self.n_layers} layers")
        object.__setattr__(self, "boundaries", b)
        if not isinstance(self.policy, str):
            pol = tuple(self.policy)
            if len(pol) != self.n_segments:
                raise ValueError(
                    f"per-segment policy count {len(pol)} != "
                    f"{self.n_segments} segments")
            object.__setattr__(self, "policy", pol)

    @property
    def n_segments(self) -> int:
        return len(self.boundaries) + 1

    def segments(self) -> list[tuple[int, int]]:
        bounds = (0, *self.boundaries, self.n_layers)
        return list(zip(bounds[:-1], bounds[1:]))

    def segment_policy(self, j: int) -> str:
        return self.policy if isinstance(self.policy, str) else self.policy[j]

    def segment_sizes(self) -> list[int]:
        return [hi - lo for lo, hi in self.segments()]

    @classmethod
    def uniform(cls, n_layers: int, num_segments: int,
                policy: str = "full") -> "RematPlan":
        """Even split — the legacy knob expressed as a plan."""
        k = max(1, min(int(num_segments), n_layers))
        bounds = sorted({round(i * n_layers / k) for i in range(1, k)}
                        - {0, n_layers})
        return cls(n_layers, tuple(bounds), policy, source="uniform")

    # -- serialization (reproducible runs) ---------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "n_layers": self.n_layers,
            "boundaries": list(self.boundaries),
            "policy": (self.policy if isinstance(self.policy, str)
                       else list(self.policy)),
            "source": self.source,
        })

    @classmethod
    def from_json(cls, text: str) -> "RematPlan":
        d = json.loads(text)
        pol = d.get("policy", "full")
        return cls(int(d["n_layers"]), tuple(d.get("boundaries", ())),
                   pol if isinstance(pol, str) else tuple(pol),
                   d.get("source", ""))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "RematPlan":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# Shared pieces.
# ---------------------------------------------------------------------------
def _prefix(values: Sequence[float]) -> list[float]:
    out = [0.0]
    for v in values:
        out.append(out[-1] + v)
    return out


def _live_prefix(act_bytes: Sequence[int],
                 resid_bytes: "Sequence[int] | None") -> list[float]:
    """Prefix sums of the per-layer LIVE bytes during a segment's backward:
    the recomputed carry plus the layer's own backward residuals (for
    attention layers, a plain path's O(S^2) probability matrix or the flash
    path's O(S*D) stats)."""
    if resid_bytes is None:
        return _prefix(act_bytes)
    if len(resid_bytes) != len(act_bytes):
        raise ValueError(
            f"resid_bytes length {len(resid_bytes)} != {len(act_bytes)}")
    return _prefix([a + r for a, r in zip(act_bytes, resid_bytes)])


def plan_metrics(act_bytes: Sequence[int], flops: Sequence[float],
                 boundaries: Sequence[int],
                 resid_bytes: "Sequence[int] | None" = None) -> dict:
    """Cost model of a placement: stored/live/peak bytes + recompute FLOPs.

    ``resid_bytes`` (optional, per layer) are backward residuals live
    during the segment's backward but NOT stored at checkpoint boundaries
    — they widen ``max_live_bytes`` only.  ``recompute_flops`` is exact
    for the sequential execution form (``checkpoint_sequential`` leaves
    the last segment un-rematted) and a LOWER bound for the scan form,
    where ``remat_scan`` remats every segment — there the true recompute
    is ~all forward FLOPs regardless of placement, and boundary choice
    trades stored vs live bytes only.
    """
    n = len(act_bytes)
    b = sorted(boundaries)
    pl_ = _live_prefix(act_bytes, resid_bytes)
    fp = _prefix(flops)
    bounds = [0, *b, n]
    stored = sum(act_bytes[x - 1] for x in b)
    max_live = max(pl_[hi] - pl_[lo] for lo, hi in zip(bounds[:-1],
                                                      bounds[1:]))
    return {
        "stored_bytes": int(stored),
        "max_live_bytes": int(max_live),
        "peak_bytes": int(stored + max_live),
        # every segment before the last boundary is re-run in the backward
        "recompute_flops": float(fp[b[-1]]) if b else 0.0,
        "n_segments": len(b) + 1,
    }


def _pareto(states):
    """Prune (stored, max_live, bounds) states: keep the (stored ↑, live ↓)
    frontier."""
    states.sort(key=lambda s: (s[0], s[1]))
    out, best_live = [], float("inf")
    for s in states:
        if s[1] < best_live:
            out.append(s)
            best_live = s[1]
    return out


# ---------------------------------------------------------------------------
# Dual: fixed checkpoint count -> min peak (the JAX package's DP).
# ---------------------------------------------------------------------------
def min_peak_boundaries(act_bytes: Sequence[int], num_checkpoints: int,
                        resid_bytes: "Sequence[int] | None" = None
                        ) -> list[int]:
    """Place ``num_checkpoints`` boundaries minimizing stored + max live.

    ``resid_bytes`` widen each layer's live contribution (backward
    residuals recomputed/held inside the segment) without being storable
    at boundaries — segments rich in plain-attention S^2 residuals get cut
    shorter, flash segments longer.
    """
    n = len(act_bytes)
    k = min(num_checkpoints, n - 1)
    if k <= 0 or n <= 1:
        return []
    sizes = list(act_bytes)
    p = _live_prefix(sizes, resid_bytes)

    def seg_cost(lo, hi):
        return p[hi] - p[lo]

    memo: dict[tuple[int, int], list] = {}

    def solve(j: int, i: int):
        key = (j, i)
        if key in memo:
            return memo[key]
        if j == 0:
            states = [(0, seg_cost(0, i), ())]
        else:
            states = []
            for b in range(j, i):
                for stored, mx, bounds in solve(j - 1, b):
                    states.append((stored + sizes[b - 1],
                                   max(mx, seg_cost(b, i)), bounds + (b,)))
            states = _pareto(states)
        memo[key] = states
        return states

    final = solve(k, n)
    best = min(final, key=lambda s: s[0] + s[1])
    return list(best[2])


# ---------------------------------------------------------------------------
# Primal: byte budget -> min recompute FLOPs.
# ---------------------------------------------------------------------------
def budget_boundaries(act_bytes: Sequence[int], flops: Sequence[float],
                      budget_bytes: float,
                      resid_bytes: "Sequence[int] | None" = None
                      ) -> tuple[list[int], bool]:
    """Minimize recompute FLOPs subject to ``peak_bytes <= budget``.

    Returns ``(boundaries, feasible)``.  When no placement fits the budget,
    the globally peak-minimal placement is returned with ``feasible=False``
    (best effort — the caller decides whether to warn or abort).
    ``resid_bytes`` enter the live-set (peak) term only, as in
    :func:`plan_metrics`.
    """
    n = len(act_bytes)
    sizes = list(act_bytes)
    p = _live_prefix(sizes, resid_bytes)

    def live(lo, hi):
        return p[hi] - p[lo]

    if n <= 1 or live(0, n) <= budget_bytes:
        return [], True  # everything fits without any remat

    # h[L]: Pareto (stored, max_live, bounds) over chains of checkpoints in
    # (0, L] whose LAST checkpoint is exactly at L.
    h: dict[int, list] = {}
    for L in range(1, n):
        states = [(sizes[L - 1], live(0, L), (L,))]
        for prev in range(1, L):
            for stored, mx, bounds in h[prev]:
                states.append((stored + sizes[L - 1],
                               max(mx, live(prev, L)), bounds + (L,)))
        h[L] = _pareto(states)

    # recompute FLOPs = prefix_flops(L): scan L ascending, first feasible
    # last-boundary wins; among its placements take the peak-minimal one.
    for L in range(1, n):
        feasible = [(stored + max(mx, live(L, n)), bounds)
                    for stored, mx, bounds in h[L]
                    if stored + max(mx, live(L, n)) <= budget_bytes]
        if feasible:
            _, bounds = min(feasible)
            return list(bounds), True

    candidates = [(live(0, n), ())]
    for L in range(1, n):
        for stored, mx, bounds in h[L]:
            candidates.append((stored + max(mx, live(L, n)), bounds))
    _, bounds = min(candidates, key=lambda c: c[0])
    return list(bounds), False
