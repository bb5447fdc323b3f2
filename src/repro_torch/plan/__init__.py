"""Remat plans (counterpart of ``repro.plan``).  Only the plan artifact is
ported so far; the profiler and the budget solvers come with slice E."""
from repro_torch.plan.solver import RematPlan

__all__ = ["RematPlan"]
