"""Memory planner (counterpart of ``repro.plan``): ``profile_*`` measures a
model's layer chain, ``plan_*`` solves for checkpoint placement, and the
resulting :class:`RematPlan` is executed by
``repro_torch.core.checkpoint.CheckpointConfig(plan=...)``, the single
remat entry point for every model stack."""
from repro_torch.plan.profile import (ChainProfile, attn_resid_bytes,
                                      decode_tile_report,
                                      flash_attn_flop_report,
                                      flash_bwd_recompute_flops,
                                      flash_training_eligible,
                                      kv_cache_report, plan_for_budget,
                                      plan_min_peak, plan_report,
                                      profile_resnet, profile_sequential,
                                      profile_transformer,
                                      serve_capacity_report)
from repro_torch.plan.solver import (RematPlan, budget_boundaries,
                                     min_peak_boundaries, plan_metrics)

__all__ = [
    "ChainProfile", "RematPlan",
    "profile_sequential", "profile_resnet", "profile_transformer",
    "attn_resid_bytes", "flash_attn_flop_report",
    "flash_bwd_recompute_flops", "flash_training_eligible",
    "decode_tile_report", "kv_cache_report", "serve_capacity_report",
    "plan_min_peak", "plan_for_budget", "plan_report",
    "min_peak_boundaries", "budget_boundaries", "plan_metrics",
]
