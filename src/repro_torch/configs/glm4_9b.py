"""GLM-4-9B [hf:THUDM]: GQA kv=2, half-dim rotary."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv=2, d_ff=13696,
        vocab=151552, rope_fraction=0.5,
    )
