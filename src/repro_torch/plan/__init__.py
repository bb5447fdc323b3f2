"""Memory planner (counterpart of ``repro.plan``): ``profile_*`` measures a
layer chain, ``plan_*`` solves for checkpoint placement, and the resulting
:class:`RematPlan` is executed by
``repro_torch.core.checkpoint.CheckpointConfig(plan=...)``.  The
transformer reports of the JAX package's planner come with a later slice."""
from repro_torch.plan.profile import (ChainProfile, plan_for_budget,
                                      plan_min_peak, plan_report,
                                      profile_resnet, profile_sequential)
from repro_torch.plan.solver import (RematPlan, budget_boundaries,
                                     min_peak_boundaries, plan_metrics)

__all__ = [
    "ChainProfile", "RematPlan",
    "profile_sequential", "profile_resnet",
    "plan_min_peak", "plan_for_budget", "plan_report",
    "min_peak_boundaries", "budget_boundaries", "plan_metrics",
]
