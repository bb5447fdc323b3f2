"""Training step factory: OpTorch S-C x M-P x gradient accumulation x
AdamW on one device (counterpart of ``repro.train.train_step``).

``make_train_step`` is the production entry: it resolves the remat plan
(:func:`resolve_remat`: a memory budget solves a ``RematPlan`` from the
transformer profile) and builds the step.  ``build_train_step`` assembles
the step:
  - mixed precision (the forward casts f32 master weights per use, with
    optional fp16 dynamic loss scaling),
  - sequential-checkpoint remat over the block stack,
  - gradient accumulation over microbatches into f32 accumulators,
  - AdamW with clipping and schedule, skipping a non-finite step on the
    device (``torch.where``) without a host sync.
The JAX package jits the step with mesh shardings; the port runs it
eagerly on the device of the model (the mesh comes with the distributed
slice, so the planner's microbatch is ``batch // accum``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.checkpoint import CheckpointConfig
from repro_torch.core.mixed_precision import (LossScale, get_policy,
                                              scaled_value_and_grad)
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    policy: str = "bf16"
    remat: CheckpointConfig = CheckpointConfig(enabled=True, policy="full",
                                               segment_size=1)
    accum: int = 1                      # gradient-accumulation microbatches
    use_loss_scale: bool = False        # fp16 path
    skip_nonfinite: bool = False        # NaN/Inf-grad steps apply no update
    #   (fp16 loss scaling always skips; this extends the guard to the
    #   other policies -- see train/guards.py for the escalation layer)
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    mem_budget_mb: int = 0              # >0: auto-solve a RematPlan to fit


def microbatch_specs(batch_sds: dict, *, accum: int = 1) -> dict:
    """The microbatch token spec the remat planner budgets for: batch /
    accum steps, as a ``device="meta"`` tensor.  The one place this
    formula lives; the launcher reuses it."""
    b, s = batch_sds["tokens"].shape
    return {"tokens": torch.empty((max(1, b // max(1, accum)), s),
                                  dtype=torch.int32, device="meta")}


def plan_profile(cfg: ModelConfig, tc: TrainConfig, batch_sds: dict):
    """The ChainProfile the planner budgets against for this train config:
    the microbatch, in the policy's compute dtype, with the flash
    residuals at ``Policy.flash_resid_dtype``'s width.  The one source
    for :func:`resolve_remat` and the launcher's ``--remat auto``."""
    from repro_torch import plan as plan_mod
    pol = get_policy(tc.policy)
    dtype_bytes = pol.compute_dtype.itemsize
    flash_resid_bytes = None if pol.flash_resid_dtype is None else \
        pol.flash_resid_dtype.itemsize
    return plan_mod.profile_transformer(
        cfg, microbatch_specs(batch_sds, accum=tc.accum),
        dtype_bytes=dtype_bytes, flash_resid_bytes=flash_resid_bytes)


def resolve_remat(cfg: ModelConfig, tc: TrainConfig,
                  batch_sds: dict) -> TrainConfig:
    """Fill ``tc.remat.plan`` from the memory planner when a budget is set.

    Profiles the block stack at microbatch shape in the policy's compute
    dtype (:func:`plan_profile`) and solves min-recompute s.t. peak <=
    budget.  A plan already present (e.g. loaded from a run's
    ``remat_plan.json``) wins; an explicit plan is validated against the
    model depth either way."""
    if tc.remat.plan is not None:
        tc.remat.validated_plan(cfg.n_layers)
        return tc
    if tc.mem_budget_mb <= 0 or not tc.remat.enabled:
        return tc
    from repro_torch import plan as plan_mod
    prof = plan_profile(cfg, tc, batch_sds)
    rp = plan_mod.plan_for_budget(prof, tc.mem_budget_mb * 2 ** 20,
                                  policy=tc.remat.policy)
    return dataclasses.replace(
        tc, remat=dataclasses.replace(tc.remat, plan=rp))


def make_train_step(cfg: ModelConfig, tc: TrainConfig, batch_sds: dict):
    """:func:`resolve_remat` then :func:`build_train_step` -> (step, the
    resolved TrainConfig).  No sharding: one device."""
    tc = resolve_remat(cfg, tc, batch_sds)
    return build_train_step(cfg, tc), tc


def build_train_step(cfg: ModelConfig, tc: TrainConfig):
    """-> ``train_step(model, opt_state, loss_scale, batch)`` returning
    ``(model, opt_state, loss_scale, metrics)``.

    ``model`` holds the f32 master weights with ``requires_grad`` on;
    the step updates them and ``opt_state`` in place.  ``metrics`` are
    0-d device tensors: loss, grads_finite, grad_norm, lr."""
    policy = get_policy(tc.policy)
    if tc.accum < 1:
        raise ValueError(f"accum must be >= 1, got {tc.accum}")

    def loss_for(model, mb):
        return transformer.loss_fn(model, cfg, mb, policy=policy,
                                   remat=tc.remat)

    def compute_grads(model, ls, batch):
        vg = scaled_value_and_grad(loss_for, ls)
        if tc.accum == 1:
            (loss, _aux), grads, finite = vg(model, batch)
            return loss, grads, finite
        b = batch["tokens"].shape[0]
        if b % tc.accum:
            raise ValueError(f"batch {b} does not split into {tc.accum} "
                             f"microbatches")
        mb_size = b // tc.accum
        loss_acc = grads_acc = finite_acc = None
        for i in range(tc.accum):
            # along the batch axis: axis 1 of M-RoPE's (3, B, S) positions,
            # axis 0 of the tokens, labels, frames and patches
            mb = {k: v[:, i * mb_size:(i + 1) * mb_size]
                  if k == "positions" and v.ndim == 3
                  else v[i * mb_size:(i + 1) * mb_size]
                  for k, v in batch.items()}
            (loss, _aux), grads, finite = vg(model, mb)
            if grads_acc is None:
                loss_acc, grads_acc, finite_acc = loss, grads, finite
            else:
                loss_acc = loss_acc + loss
                finite_acc = finite_acc & finite
                for n, g in grads.items():
                    grads_acc[n] += g
        inv = 1.0 / tc.accum
        return loss_acc * inv, {n: g * inv for n, g in grads_acc.items()}, \
            finite_acc

    decay: dict = {}

    def train_step(model, opt_state, loss_scale, batch):
        params = {n: p for n, p in model.named_parameters()
                  if p.requires_grad}
        if not params:
            raise ValueError("train_step: the model has no trainable "
                             "parameters; call model.requires_grad_()")
        ls = loss_scale if tc.use_loss_scale else None
        if decay.keys() != params.keys():   # rebuilt only for a new model
            decay.clear()
            decay.update(adamw.jax_layout_decay_mask(params))
        loss, grads, finite = compute_grads(model, ls, batch)
        skip = ~finite if (tc.use_loss_scale or tc.skip_nonfinite) else None
        _, opt_state, metrics = adamw.update(
            tc.opt, grads, opt_state, params, decay=decay, skip=skip)
        new_ls = loss_scale.update(finite) if tc.use_loss_scale \
            else loss_scale
        metrics = {"loss": loss, "grads_finite": finite, **metrics}
        return model, opt_state, new_ls, metrics

    return train_step


def init_loss_scale(tc: TrainConfig, device) -> LossScale:
    return LossScale.init(device=device) if tc.use_loss_scale \
        else LossScale.noop(device=device)
