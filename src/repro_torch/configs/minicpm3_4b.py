"""MiniCPM3-4B [hf:openbmb]: MLA (multi-head latent attention) decoder."""
from repro_torch.models.config import MLAConfig, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="minicpm3-4b", family="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv=40, d_ff=6400,
        vocab=73448, head_dim=96,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                      qk_rope_dim=32, v_head_dim=64),
    )
