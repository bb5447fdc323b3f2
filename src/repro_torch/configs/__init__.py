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


# ---------------------------------------------------------------------------
# Assigned input shapes (the reference's ``SHAPES``), and the dry run's
# stand-ins for every model input of a cell.
# ---------------------------------------------------------------------------
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """long_500k only for the sub-quadratic archs, as in the reference."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        shapes.append("long_500k")
    return shapes


def input_specs(cfg: ModelConfig, shape_name: str, *,
                reduced: bool = False) -> dict:
    """``device="meta"`` stand-ins for every model input of this cell, at
    the reference's global shapes and dtypes (its ``ShapeDtypeStruct``s):

    ``kind='train'``   -> {tokens, labels[, frames / patches, positions]}
    ``kind='prefill'`` -> {tokens[, frames / patches, positions]}
    ``kind='decode'``  -> {tokens_t, cache[, enc_out]}, the cache
    ``transformer.init_cache(quantized=True)``'s, whole.

    ``reduced`` caps seq at 64 and batch at 4."""
    import torch
    sh = dict(SHAPES[shape_name])
    if reduced:
        sh.update(seq=min(sh["seq"], 64), batch=min(sh["batch"], 4))
    b, s = sh["batch"], sh["seq"]
    f32, i32 = torch.float32, torch.int32

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if sh["kind"] in ("train", "prefill"):
        specs = {"tokens": meta((b, s), i32)}
        if sh["kind"] == "train":
            specs["labels"] = meta((b, s), i32)
        if cfg.encoder is not None:
            specs["frames"] = meta((b, cfg.encoder.n_frames, cfg.d_model),
                                   f32)
        if cfg.family == "vlm":
            specs["patches"] = meta((b, min(1024, s // 4), cfg.d_model), f32)
            specs["positions"] = meta((3, b, s), i32)
        return specs

    # decode: one new token against a cache of length seq (the steps
    # continue text only: a VLM's positions are tracked 1-D)
    from repro_torch.models import transformer
    specs = {"tokens_t": meta((b,), i32),
             "cache": transformer.init_cache(cfg, b, s, quantized=True,
                                             device="meta")}
    if cfg.encoder is not None:
        specs["enc_out"] = meta((b, cfg.encoder.n_frames, cfg.d_model), f32)
    return specs
