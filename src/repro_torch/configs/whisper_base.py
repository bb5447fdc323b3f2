"""Whisper-base [arXiv:2212.04356]: encoder-decoder; the conv frontend is
a stub -- the encoder takes precomputed frame embeddings (B, 1500,
d_model)."""
from repro_torch.models.config import EncoderConfig, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-base", family="encdec",
        n_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048,
        vocab=51865, mlp_kind="gelu",
        encoder=EncoderConfig(n_layers=6, n_frames=1500),
    )
