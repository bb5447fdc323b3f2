"""StableLM-2-12B [hf:stabilityai]: dense GQA decoder, head_dim 160."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="stablelm-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_ff=13824,
        vocab=100352,
    )
