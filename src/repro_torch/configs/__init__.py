"""Architecture registry: ``get_config(arch_id)`` and the reduced
``smoke_config`` (counterparts of ``repro.configs``), for every
architecture of the JAX package.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import (EncoderConfig, MLAConfig,
                                       ModelConfig, SSMConfig)

ARCHS = ["llama3_8b", "mamba2_130m", "hymba_1_5b", "glm4_9b",
         "deepseek_moe_16b", "granite_moe_3b_a800m", "stablelm_12b",
         "minicpm3_4b", "whisper_base", "qwen2_vl_2b"]


def _mod(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def list_archs() -> list[str]:
    return [a.replace("_", "-") for a in ARCHS]


def get_config(arch_id: str) -> ModelConfig:
    if _mod(arch_id) not in ARCHS:
        raise ValueError(f"unknown arch {arch_id!r} (known: {list_archs()})")
    mod = importlib.import_module(f"repro_torch.configs.{_mod(arch_id)}")
    return mod.get_config()


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced smoke variant: same family and code paths, laptop-sized
    (the same reduction as ``repro.configs.smoke_config``)."""
    cfg = get_config(arch_id)
    kw: dict = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv=min(cfg.n_kv, 2) or 0,
        d_ff=128 if cfg.d_ff else 0, vocab=256, head_dim=16,
        global_layers=(0,) if cfg.global_layers else (),
        window=16 if cfg.window else 0)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, d_expert=32,
            d_shared=64 if cfg.moe.num_shared else 0)
        kw["d_ff"] = 0
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8,
                              qk_rope_dim=8, v_head_dim=8)
        kw["head_dim"] = 16
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_inner=64, head_p=16, chunk=32)
    if cfg.encoder is not None:
        kw["encoder"] = EncoderConfig(n_layers=2, n_frames=32)
    if cfg.mrope_sections is not None:
        kw["mrope_sections"] = (4, 2, 2)
    return dataclasses.replace(cfg, **kw)
