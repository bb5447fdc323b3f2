"""Chain profiling: per-layer activation bytes + recompute FLOPs (the
sequential-chain part of ``repro.plan.profile``).

The planner (``solver``) needs, for every candidate checkpoint site, (a)
how many bytes the activation at that site occupies and (b) how expensive
the layers before it are to re-run.  This module gets both WITHOUT
allocating anything:

  * activation bytes by walking the layer functions on ``device="meta"``
    tensors (shapes and dtypes only, as ``jax.eval_shape`` does in the JAX
    package), so they equal the JAX package's byte for byte;
  * FLOPs analytically, from the shapes each layer's operators see
    (``torch.utils.flop_counter``: 2 per multiply-add of the convolutions
    and matrix products; 2 per output element for a layer with none).  The
    JAX package asks XLA's cost analysis, which has no counterpart here,
    so the FLOPs differ from its numbers.  ``plan_min_peak`` does not read
    them; ``plan_for_budget`` uses them only to order placements.

The transformer reports of the JAX module come with the planner slice.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Callable, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.plan.solver import (RematPlan, budget_boundaries,
                                     min_peak_boundaries, plan_metrics)


@dataclasses.dataclass(frozen=True)
class ChainProfile:
    """Per-layer costs of a sequential chain (index i = layer i's output).

    ``resid_bytes`` (optional, same length) are per-layer BACKWARD
    residuals: bytes live while that layer's segment backward runs, beyond
    the checkpointable carry.  They widen the planner's live-set term but
    are never stored at checkpoint boundaries.
    """

    act_bytes: tuple[int, ...]
    flops: tuple[float, ...]
    labels: tuple[str, ...] = ()
    resid_bytes: tuple[int, ...] = ()

    def __post_init__(self):
        if len(self.act_bytes) != len(self.flops):
            raise ValueError("act_bytes and flops length mismatch")
        if self.resid_bytes and len(self.resid_bytes) != len(self.act_bytes):
            raise ValueError("resid_bytes and act_bytes length mismatch")

    @property
    def n_layers(self) -> int:
        return len(self.act_bytes)

    @property
    def resid_or_none(self) -> "tuple[int, ...] | None":
        """What the solvers take: None when no residuals were profiled."""
        return self.resid_bytes or None

    def total_bytes(self) -> int:
        return int(sum(self.act_bytes))

    def total_resid_bytes(self) -> int:
        return int(sum(self.resid_bytes))

    def total_flops(self) -> float:
        return float(sum(self.flops))

    def to_json(self) -> str:
        return json.dumps({"act_bytes": list(self.act_bytes),
                           "flops": list(self.flops),
                           "labels": list(self.labels),
                           "resid_bytes": list(self.resid_bytes)})

    @classmethod
    def from_json(cls, text: str) -> "ChainProfile":
        d = json.loads(text)
        return cls(tuple(d["act_bytes"]), tuple(d["flops"]),
                   tuple(d.get("labels", ())),
                   tuple(d.get("resid_bytes", ())))


def _meta(x: torch.Tensor) -> torch.Tensor:
    """A meta tensor of ``x``'s shape, strides and dtype."""
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device="meta")


# ---------------------------------------------------------------------------
# Chain walkers.
# ---------------------------------------------------------------------------
def profile_sequential(layer_fns: Sequence[Callable], x0: torch.Tensor,
                       labels: Sequence[str] = ()) -> ChainProfile:
    """Walk an explicit chain of tensor -> tensor layer functions on meta
    tensors; never allocates.  ``layer_fns`` must close over meta
    parameters (or none)."""
    x = _meta(x0)
    act, flops = [], []
    with torch.no_grad():
        for fn in layer_fns:
            with FlopCounterMode(display=False) as counter:
                x = fn(x)
            n = counter.get_total_flops()
            flops.append(float(n) if n > 0 else 2.0 * x.numel())
            act.append(x.numel() * x.element_size())
    return ChainProfile(tuple(act), tuple(flops),
                        tuple(labels) if labels else ())


def profile_resnet(params, cfg, image) -> ChainProfile:
    """Profile the ResNet layer list ``checkpoint_sequential`` consumes.
    ``image``: a tensor (any device, meta included) with the NHWC shape
    and dtype of the batch the chain will see."""
    from repro_torch.models import cnn
    fns = cnn.layer_fns({n: _meta(p) for n, p in params.items()}, cfg)
    labels = ["stem"] + [f"block{i}" for i in range(len(fns) - 2)] + ["head"]
    return profile_sequential(fns, image.permute(0, 3, 1, 2), labels)


# ---------------------------------------------------------------------------
# Profile -> plan.
# ---------------------------------------------------------------------------
def plan_min_peak(profile: ChainProfile, num_checkpoints: int,
                  policy: str = "full") -> RematPlan:
    """Dual solver: best placement of a fixed number of checkpoints."""
    bounds = min_peak_boundaries(profile.act_bytes, num_checkpoints,
                                 resid_bytes=profile.resid_or_none)
    return RematPlan(profile.n_layers, tuple(bounds), policy,
                     source=f"min_peak:k={num_checkpoints}")


def plan_for_budget(profile: ChainProfile, budget_bytes: float,
                    policy: str = "full") -> RematPlan:
    """Primal solver: min recompute FLOPs with peak bytes <= budget.

    An unsatisfiable budget yields the peak-minimal best-effort plan,
    tagged ``:infeasible`` in ``source`` AND warned about, so the violated
    constraint is never silent.
    """
    bounds, feasible = budget_boundaries(profile.act_bytes, profile.flops,
                                         budget_bytes,
                                         resid_bytes=profile.resid_or_none)
    tag = f"budget:{int(budget_bytes)}" + ("" if feasible else ":infeasible")
    if not feasible:
        peak = plan_metrics(profile.act_bytes, profile.flops, bounds,
                            resid_bytes=profile.resid_or_none)["peak_bytes"]
        warnings.warn(
            f"remat budget {budget_bytes/2**20:.1f} MiB is infeasible for "
            f"this chain; best-effort plan peaks at {peak/2**20:.1f} MiB "
            f"(min achievable)", stacklevel=2)
    return RematPlan(profile.n_layers, tuple(bounds), policy, source=tag)


def plan_report(profile: ChainProfile, plan: RematPlan) -> dict:
    """Human/JSON-facing summary of a plan against its profile."""
    m = plan_metrics(profile.act_bytes, profile.flops, plan.boundaries,
                     resid_bytes=profile.resid_or_none)
    return {
        "source": plan.source,
        "n_layers": plan.n_layers,
        "boundaries": list(plan.boundaries),
        "segment_sizes": plan.segment_sizes(),
        **m,
        "recompute_frac": (m["recompute_flops"] / profile.total_flops()
                           if profile.total_flops() else 0.0),
        "no_remat_bytes": profile.total_bytes(),
        "resid_bytes_total": profile.total_resid_bytes(),
    }
