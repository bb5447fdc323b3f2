"""Hymba-1.5B [arXiv:2411.13676]: hybrid parallel attention + mamba heads,
sliding-window attention except 3 global layers (meta-tokens omitted, as
in the JAX package)."""
from repro_torch.models.config import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="hymba-1.5b", family="hybrid", mixer="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv=5, d_ff=5504,
        vocab=32001, head_dim=64, window=1024, global_layers=(0, 15, 31),
        ssm=SSMConfig(d_state=16, d_inner=1600, head_p=64),
        subquadratic=True,
    )
