"""Mamba2-130M [arXiv:2405.21060]: attention-free SSD; O(1) decode state."""
from repro_torch.models.config import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-130m", family="ssm", mixer="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv=0, d_ff=0,
        vocab=50280, head_dim=0,
        ssm=SSMConfig(d_state=128, d_inner=1536, head_p=64),
        subquadratic=True,
    )
