"""IBM Granite-3.0 MoE (3b-a800m class) [hf:ibm-granite]: 40 experts top-8,
per-expert FFN 512."""
from repro_torch.models.config import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv=8, d_ff=0,
        vocab=49155,
        moe=MoEConfig(num_experts=40, top_k=8, d_expert=512),
    )
