"""DeepSeek-MoE-16B [arXiv:2401.06066]: fine-grained MoE, 2 shared + 64
routed experts, top-6.  (HF layer 0 is a dense MLP; the reference keeps a
uniform MoE stack, and so does the port.)"""
from repro_torch.models.config import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv=16, d_ff=0,
        vocab=102400, rope_theta=10000.0,
        moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408,
                      num_shared=2, d_shared=2816),
    )
