"""Qwen2-VL-2B [arXiv:2409.12191]: M-RoPE decoder; the vision tower is a
stub -- precomputed patch embeddings (B, Sp, d_model) fill the prompt's
prefix."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2-vl-2b", family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv=2, d_ff=8960,
        vocab=151936, head_dim=128, rope_theta=1000000.0,
        mrope_sections=(16, 24, 24), tie_embeddings=True,
    )
