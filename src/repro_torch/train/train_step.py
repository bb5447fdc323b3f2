"""Training step factory: OpTorch S-C x M-P x gradient accumulation x
AdamW, on one device or data-parallel over a process group (counterpart
of ``repro.train.train_step``).

``make_train_step`` is the production entry: it resolves the remat plan
(:func:`resolve_remat`: a memory budget solves a ``RematPlan`` from the
transformer profile of the per-device microbatch) and builds the step.
``build_train_step`` assembles the step:
  - mixed precision (the forward casts f32 master weights per use, with
    optional fp16 dynamic loss scaling),
  - sequential-checkpoint remat over the block stack,
  - gradient accumulation over microbatches into f32 accumulators,
  - AdamW with clipping and schedule, skipping a non-finite step on the
    device (``torch.where``) without a host sync.
The JAX package jits the step with mesh shardings; the port runs it
eagerly on the device of the model.  With a ``launch/mesh.py`` ``Mesh``
whose DP size (``sharding.dp_size``) is > 1, inside an initialized
process group of that many ranks, each rank holds a full replica, takes
its rows of the global batch (``sharding.batch_specs``), runs the step
above on them (the flash kernels per rank, on the local batch, as the
reference's ``shard_map`` runs them when only the batch shards), and
all-reduces the f32 gradients, the loss and the finite flag to their
global values before AdamW, so every rank takes the same update or the
same skip.  A mesh whose model axis is > 1 (tensor parallelism) is not
ported yet and raises.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core.checkpoint import CheckpointConfig
from repro_torch.core.mixed_precision import (LossScale, get_policy,
                                              scaled_value_and_grad)
from repro_torch.distributed import sharding as shd
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


def microbatch_specs(batch_sds: dict, *, accum: int = 1, mesh=None) -> dict:
    """The per-device microbatch token spec the remat planner budgets
    for: global batch / (DP shards x accum steps), as a
    ``device="meta"`` tensor.  The one place this formula lives; the
    launcher reuses it."""
    b, s = batch_sds["tokens"].shape
    dp = shd.dp_size(mesh) if mesh is not None else 1
    return {"tokens": torch.empty((max(1, b // (dp * max(1, accum))), s),
                                  dtype=torch.int32, device="meta")}


def plan_profile(cfg: ModelConfig, tc: TrainConfig, batch_sds: dict,
                 mesh=None):
    """The ChainProfile the planner budgets against for this train config:
    the per-device microbatch, in the policy's compute dtype, with the
    flash residuals at ``Policy.flash_resid_dtype``'s width, divided by
    the mesh's model shards.  The one source for :func:`resolve_remat`
    and the launcher's ``--remat auto``."""
    from repro_torch import plan as plan_mod
    pol = get_policy(tc.policy)
    dtype_bytes = pol.compute_dtype.itemsize
    flash_resid_bytes = None if pol.flash_resid_dtype is None else \
        pol.flash_resid_dtype.itemsize
    model_shards = 1
    if mesh is not None and "model" in mesh.axis_names:
        model_shards = mesh.shape["model"]
    return plan_mod.profile_transformer(
        cfg, microbatch_specs(batch_sds, accum=tc.accum, mesh=mesh),
        dtype_bytes=dtype_bytes, flash_resid_bytes=flash_resid_bytes,
        model_shards=model_shards)


def resolve_remat(cfg: ModelConfig, tc: TrainConfig, batch_sds: dict,
                  mesh=None) -> TrainConfig:
    """Fill ``tc.remat.plan`` from the memory planner when a budget is set.

    Profiles the block stack at the per-device microbatch shape in the
    policy's compute dtype (:func:`plan_profile`) and solves
    min-recompute s.t. peak <= budget.  A plan already present (e.g.
    loaded from a run's ``remat_plan.json``) wins; an explicit plan is
    validated against the model depth either way."""
    if tc.remat.plan is not None:
        tc.remat.validated_plan(cfg.n_layers)
        return tc
    if tc.mem_budget_mb <= 0 or not tc.remat.enabled:
        return tc
    from repro_torch import plan as plan_mod
    prof = plan_profile(cfg, tc, batch_sds, mesh=mesh)
    rp = plan_mod.plan_for_budget(prof, tc.mem_budget_mb * 2 ** 20,
                                  policy=tc.remat.policy)
    return dataclasses.replace(
        tc, remat=dataclasses.replace(tc.remat, plan=rp))


def make_train_step(cfg: ModelConfig, tc: TrainConfig, batch_sds: dict,
                    mesh=None):
    """:func:`resolve_remat` then :func:`build_train_step` -> (step, the
    resolved TrainConfig)."""
    tc = resolve_remat(cfg, tc, batch_sds, mesh=mesh)
    return build_train_step(cfg, tc, mesh=mesh), tc


def _dp_group(mesh):
    """The process group a step with ``mesh`` reduces over, or None (no
    reduction): the default group whenever one is initialized (its size
    must be the mesh's DP size), none for a DP size of 1 without one."""
    if mesh is None:
        return None
    if "model" in mesh.axis_names and mesh.shape["model"] > 1:
        raise NotImplementedError(
            f"train step on {mesh}: a model axis > 1 is tensor-parallel "
            f"training, which comes with the tensor-parallel slice of the "
            f"distributed port; use a (data, 1) mesh")
    n_dp = shd.dp_size(mesh)
    if not dist.is_initialized():
        if n_dp > 1:
            raise RuntimeError(f"train step on {mesh}: data parallelism "
                               f"needs an initialized process group")
        return None
    if dist.get_world_size() != n_dp:
        raise RuntimeError(f"train step on {mesh}: the process group has "
                           f"{dist.get_world_size()} ranks, the mesh's "
                           f"DP size is {n_dp}")
    return dist.group.WORLD


def local_batch(cfg: ModelConfig, batch: dict, mesh, rank: int) -> dict:
    """Rank ``rank``'s rows of a global batch: each leaf split along the
    dim its ``sharding.batch_specs`` entry puts on the DP axes (axis 1 of
    M-RoPE's (3, B, S) positions, axis 0 of everything else)."""
    n = shd.dp_size(mesh)
    out = {}
    for name, spec in shd.batch_specs(cfg, batch, mesh).items():
        x = batch[name]
        d = next(i for i, e in enumerate(spec) if e is not None)
        if x.shape[d] % n:
            raise ValueError(f"batch leaf {name!r}: {x.shape[d]} rows do "
                             f"not split over {n} DP ranks")
        rows = x.shape[d] // n
        out[name] = x.narrow(d, rank * rows, rows)
    return out


def build_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None):
    """-> ``train_step(model, opt_state, loss_scale, batch)`` returning
    ``(model, opt_state, loss_scale, metrics)``.

    ``model`` holds the f32 master weights with ``requires_grad`` on;
    the step updates them and ``opt_state`` in place.  ``metrics`` are
    0-d device tensors: loss, grads_finite, grad_norm, lr.  With a DP
    mesh (see the module docstring) ``batch`` is the global batch, every
    rank passes the same one, and the metrics are global."""
    policy = get_policy(tc.policy)
    if tc.accum < 1:
        raise ValueError(f"accum must be >= 1, got {tc.accum}")
    group = _dp_group(mesh)

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

    def reduce_grads(loss, grads, finite):
        """The DP mean of the loss and the f32 gradients, and the finite
        flag of every rank (MIN), so all ranks step or skip together."""
        n = dist.get_world_size(group)
        grads = {k: g.contiguous() for k, g in grads.items()}
        works = [dist.all_reduce(g, group=group, async_op=True)
                 for g in grads.values()]
        loss = loss.detach().clone()
        flag = finite.to(torch.int32)
        dist.all_reduce(loss, group=group)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
        for w in works:
            w.wait()
        for g in grads.values():
            g.div_(n)
        return loss / n, grads, flag.bool()

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
        if group is None:
            loss, grads, finite = compute_grads(model, ls, batch)
        else:
            loss, grads, finite = reduce_grads(*compute_grads(
                model, ls, local_batch(cfg, batch, mesh, dist.get_rank())))
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
