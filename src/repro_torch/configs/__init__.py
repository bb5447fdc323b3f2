"""Architecture registry: ``get_config(arch_id)`` and the reduced
``smoke_config`` (counterparts of ``repro.configs``).

Only the architectures the port can already build are registered; asking
for another one raises and names the slice that will port it.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ["llama3_8b"]

#: architectures of the reference not yet ported -> the slice that brings them
PENDING = {
    "deepseek-moe-16b": "slice F (MoE)",
    "granite-moe-3b-a800m": "slice F (MoE)",
    "stablelm-12b": "slice F (other archs)",
    "minicpm3-4b": "slice F (MLA)",
    "glm4-9b": "slice F (other archs)",
    "whisper-base": "slice F (encoder)",
    "hymba-1.5b": "slice F (hybrid, two-tier cache)",
    "qwen2-vl-2b": "slice F (M-RoPE)",
    "mamba2-130m": "slice F (SSM)",
}


def _mod(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def list_archs() -> list[str]:
    return [a.replace("_", "-") for a in ARCHS]


def get_config(arch_id: str) -> ModelConfig:
    if _mod(arch_id) not in ARCHS:
        slice_name = PENDING.get(arch_id.replace("_", "-"))
        if slice_name is not None:
            raise NotImplementedError(
                f"arch {arch_id!r} is not ported yet; it comes with "
                f"{slice_name}")
        raise ValueError(f"unknown arch {arch_id!r} (ported: {list_archs()})")
    mod = importlib.import_module(f"repro_torch.configs.{_mod(arch_id)}")
    return mod.get_config()


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced smoke variant: same family and code paths, laptop-sized
    (the same reduction as ``repro.configs.smoke_config``)."""
    cfg = get_config(arch_id)
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=4, n_kv=min(cfg.n_kv, 2) or 0,
        d_ff=128 if cfg.d_ff else 0, vocab=256, head_dim=16,
        global_layers=(0,) if cfg.global_layers else (),
        window=16 if cfg.window else 0)
