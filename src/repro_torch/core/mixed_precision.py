"""Mixed-precision dtype policies (counterpart of
``repro.core.mixed_precision``).

A ``Policy`` is a (param_dtype, compute_dtype, output_dtype) triple.  The
port casts a model to ``compute_dtype`` ONCE, when it is built or loaded
(``models.transformer.Transformer.cast_to_compute``), instead of at every
call as the JAX package does: the values are the same and serving does not
re-cast the weights every step.  ``LossScale`` and the gradient helpers
come with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32     # storage
    compute_dtype: torch.dtype = torch.bfloat16  # matmuls / activations
    output_dtype: torch.dtype = torch.float32    # logits
    flash_resid_dtype: Optional[torch.dtype] = None  # saved flash residuals

    @staticmethod
    def full() -> "Policy":       # the paper's "standard pipeline" (pure FP32)
        return Policy(torch.float32, torch.float32, torch.float32)

    @staticmethod
    def bf16() -> "Policy":
        return Policy(torch.float32, torch.bfloat16, torch.float32)

    @staticmethod
    def fp16() -> "Policy":
        return Policy(torch.float16, torch.float16, torch.float32)

    @staticmethod
    def bf16_params() -> "Policy":
        return Policy(torch.bfloat16, torch.bfloat16, torch.float32)

    @staticmethod
    def resid_bf16() -> "Policy":
        return Policy(torch.float32, torch.float32, torch.float32,
                      flash_resid_dtype=torch.bfloat16)


def get_policy(name: str) -> Policy:
    try:
        return {
            "full": Policy.full(),
            "fp32": Policy.full(),
            "bf16": Policy.bf16(),
            "fp16": Policy.fp16(),
            "bf16_params": Policy.bf16_params(),
            "resid_bf16": Policy.resid_bf16(),
        }[name]
    except KeyError:
        raise ValueError(f"unknown mixed-precision policy {name!r}") from None
