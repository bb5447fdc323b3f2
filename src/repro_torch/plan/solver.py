"""The remat plan artifact (a copy of ``RematPlan`` from
``repro.plan.solver``, which imports no JAX): where to cut a layer chain
into sequential-checkpoint segments, and with which policy.  A plan the
JAX package's solvers wrote (``RematPlan.save``) loads here unchanged.
The solvers themselves come with the planner (slice E).
"""
from __future__ import annotations

import dataclasses
import json


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
