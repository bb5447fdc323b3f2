"""Llama-3-8B [arXiv:2407.21783]: GQA kv=8, 128k vocab, theta 500k."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
        vocab=128256, rope_theta=500000.0,
    )
