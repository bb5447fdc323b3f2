"""Model configuration dataclasses (counterpart of ``repro.models.config``).

The port dispatches attention on the tensor's device, not on a backend
name, so ``ModelConfig`` has no ``attn_backend`` field.  The MoE / MLA /
SSM / encoder sub-configs are kept as plain fields so later slices fit;
``models.transformer`` rejects them at build time for now.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden
    num_shared: int = 0           # always-on shared experts (deepseek)
    d_shared: int = 0             # shared-expert FFN hidden (total)
    router_dtype: str = "float32"
    expert_mode: str = "tp"       # 'tp' (shard d_expert) | 'ep' (shard experts)
    capacity_factor: float = 1.25  # 0 => dropless (sort + ragged_dot)


@dataclasses.dataclass(frozen=True)
class MLAConfig:                  # Multi-head Latent Attention (MiniCPM3/DeepSeek)
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:                  # mamba2 / SSD
    d_state: int
    d_inner: int                  # = heads * head_p
    head_p: int = 64              # P, per-head channels
    conv_kernel: int = 4
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def heads(self) -> int:
        return self.d_inner // self.head_p


@dataclasses.dataclass(frozen=True)
class EncoderConfig:              # whisper-style frame encoder (frontend = stub)
    n_layers: int
    n_frames: int = 1500          # post-conv frame count the stub emits


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 => d_model // n_heads
    mixer: str = "attn"           # attn | ssm | hybrid
    mlp_kind: str = "swiglu"      # swiglu | gelu
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0    # glm4 rotates half the head dim
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl
    norm_eps: float = 1e-5
    window: int = 0               # 0 => full causal; else sliding window
    global_layers: Tuple[int, ...] = ()   # layers that override window -> full
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    tie_embeddings: bool = False
    subquadratic: bool = False    # eligible for long_500k shapes
    norm_bf16_grad: bool = False  # perf: bf16 cotangent out of RMSNorm

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (rows beyond ``vocab`` are
        dead weight; their logits are masked)."""
        return -(-self.vocab // 256) * 256
