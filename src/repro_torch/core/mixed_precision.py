"""Mixed-precision training (counterpart of ``repro.core.mixed_precision``).

A ``Policy`` is a (param_dtype, compute_dtype, output_dtype) triple.  The
model's forward casts every weight to ``compute_dtype`` where it is used
(``Tensor.to``, an autograd op), so training keeps f32 master weights and
their gradients arrive in f32 -- the paper's master-weight rule.  Serving
casts a model once when it is built (``Transformer.cast_to_compute``);
the per-use cast is then a no-op.

``LossScale`` (static or dynamic, for the fp16 path), ``all_finite`` and
``scaled_value_and_grad`` complete the pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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


# ---------------------------------------------------------------------------
# Loss scaling (needed for the paper-faithful fp16 path).
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LossScale:
    """Dynamic loss scale state (static if ``growth_interval == 0``).
    ``scale`` and ``growth_counter`` are 0-d tensors, so ``update`` runs
    on the device without a host sync."""

    scale: torch.Tensor                   # current multiplier, f32
    growth_counter: torch.Tensor          # consecutive finite steps, int32
    growth_interval: int = 2000           # 0 => static scaling
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    max_scale: float = 2.0 ** 24

    @staticmethod
    def init(initial: float = 2.0 ** 15, growth_interval: int = 2000,
             device="cpu") -> "LossScale":
        return LossScale(
            scale=torch.tensor(initial, dtype=torch.float32, device=device),
            growth_counter=torch.tensor(0, dtype=torch.int32, device=device),
            growth_interval=growth_interval)

    @staticmethod
    def noop(device="cpu") -> "LossScale":
        return LossScale.init(1.0, growth_interval=0, device=device)

    def scale_loss(self, loss):
        return loss * self.scale.to(loss.dtype)

    def unscale(self, grads: dict) -> dict:
        inv = 1.0 / self.scale
        return {n: g.float() * inv for n, g in grads.items()}

    def update(self, grads_finite: torch.Tensor) -> "LossScale":
        if self.growth_interval == 0:
            return self
        counter = torch.where(grads_finite, self.growth_counter + 1,
                              torch.zeros_like(self.growth_counter))
        grow = counter >= self.growth_interval
        new_scale = torch.where(
            grads_finite,
            torch.where(grow, torch.clamp(self.scale * self.growth_factor,
                                          max=self.max_scale), self.scale),
            torch.clamp(self.scale * self.backoff_factor, min=1.0))
        return dataclasses.replace(
            self, scale=new_scale,
            growth_counter=torch.where(grow, torch.zeros_like(counter),
                                       counter).to(torch.int32))


def all_finite(tensors) -> torch.Tensor:
    """0-d bool tensor: every floating element of every tensor is finite.
    Stays on the device (no host sync)."""
    flags = [torch.isfinite(t).all() for t in tensors
             if t.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


def scaled_value_and_grad(loss_fn: Callable,
                          loss_scale: LossScale | None = None):
    """``value_and_grad`` with the paper's master-weight semantics.

    ``loss_fn(model, *args) -> (loss, aux)`` runs the model under its
    policy: the forward casts the f32 master weights to the compute dtype
    where they are used, inside the differentiated function, so the
    gradients come back in f32.  The loss is scaled and the gradients
    unscaled when a ``loss_scale`` is given.  Returns
    ``wrapped(model, *args) -> ((loss, aux), grads, grads_finite)`` with
    ``grads`` a {parameter name: f32 tensor} dict of the trainable
    parameters and ``grads_finite`` a 0-d bool tensor."""
    def wrapped(model, *args):
        names, params = zip(*[(n, p) for n, p in model.named_parameters()
                              if p.requires_grad])
        loss, aux = loss_fn(model, *args)
        scaled = loss_scale.scale_loss(loss) if loss_scale is not None \
            else loss
        # a leaf the loss never reaches (mamba2's ln2: its blocks have no
        # MLP) gets a zero gradient, as ``jax.grad`` gives it
        grads = torch.autograd.grad(scaled.float(), params, allow_unused=True,
                                    materialize_grads=True)
        grads = {n: g.float() for n, g in zip(names, grads)}
        loss = scaled.detach().float()
        if loss_scale is not None:
            grads = loss_scale.unscale(grads)
            loss = loss / loss_scale.scale
        return (loss, aux), grads, all_finite(grads.values())

    return wrapped
