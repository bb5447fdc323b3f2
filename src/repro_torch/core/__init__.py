"""OpTorch core: the paper's Gradient-flow and Data-flow optimizations
(counterpart of ``repro.core``, the same names)."""
from repro_torch.core.api import mp, sc, sc_mp
from repro_torch.core.checkpoint import (
    CheckpointConfig,
    checkpoint_sequential,
    optimal_segments,
    remat_scan,
)
from repro_torch.core.mixed_precision import (LossScale, Policy, get_policy,
                                              scaled_value_and_grad)
from repro_torch.core import encoding

__all__ = [
    "mp", "sc", "sc_mp", "CheckpointConfig", "checkpoint_sequential",
    "optimal_segments", "remat_scan", "LossScale", "Policy", "get_policy",
    "scaled_value_and_grad", "encoding",
]
