"""Model configuration dataclasses (counterpart of ``repro.models.config``).

The port dispatches attention on the tensor's device, not on a backend
name, so ``ModelConfig`` has no ``attn_backend`` field; every other
field is the reference's.  ``param_count`` / ``active_param_count`` are the reference's analytic
counts, for every family (the MLA and encoder terms included).
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

    # ------------------------------------------------------------- sizing --
    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, n_layers = self.d_model, self.n_layers
        total = self.vocab * d                     # embed
        if not self.tie_embeddings:
            total += self.vocab * d                # lm head
        total += d                                 # final norm
        per_layer = 0
        if self.mixer in ("attn", "hybrid"):
            per_layer += d                         # ln1
            if self.mla is not None:
                m = self.mla
                per_layer += d * m.q_lora_rank + m.q_lora_rank
                per_layer += m.q_lora_rank * self.n_heads \
                    * (m.qk_nope_dim + m.qk_rope_dim)
                per_layer += d * (m.kv_lora_rank + m.qk_rope_dim) \
                    + m.kv_lora_rank
                per_layer += m.kv_lora_rank * self.n_heads \
                    * (m.qk_nope_dim + m.v_head_dim)
                per_layer += self.n_heads * m.v_head_dim * d
            else:
                hd = self.head_dim
                per_layer += d * self.n_heads * hd          # wq
                per_layer += 2 * d * self.n_kv * hd         # wk, wv
                per_layer += self.n_heads * hd * d          # wo
        if self.mixer in ("ssm", "hybrid"):
            s = self.ssm
            per_layer += d              # ln (shared with ln1 in the hybrid)
            conv_dim = s.d_inner + 2 * s.d_state
            per_layer += d * (2 * s.d_inner + 2 * s.d_state + s.heads)
            per_layer += conv_dim * s.conv_kernel
            per_layer += 3 * s.heads                # A, D, dt_bias
            per_layer += s.d_inner                  # gated norm
            per_layer += s.d_inner * d              # out_proj
        per_layer += d                             # ln2
        if self.moe is not None:
            m = self.moe
            per_layer += d * m.num_experts                   # router
            per_layer += m.num_experts * 3 * d * m.d_expert  # experts
            if m.num_shared:
                per_layer += 3 * d * m.d_shared              # shared
        elif self.d_ff:
            mult = 3 if self.mlp_kind == "swiglu" else 2
            per_layer += mult * d * self.d_ff
        total += n_layers * per_layer
        if self.encoder is not None:
            hd = self.head_dim
            attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd \
                + self.n_heads * hd * d
            total += self.encoder.n_layers * (2 * d + attn
                                              + 2 * d * self.d_ff) + d
            # the decoder's cross-attention: another attention a layer
            total += n_layers * (d + attn)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: the top-k and shared experts
        only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        per_expert = 3 * self.d_model * m.d_expert
        return self.param_count() - self.n_layers * per_expert \
            * (m.num_experts - m.top_k)
