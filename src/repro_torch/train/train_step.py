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
of (data, model) axes, inside an initialized process group of
``mesh.size`` ranks (ranks row-major, the model axis innermost):

  * each rank takes its rows of the global batch by its data coordinate
    (``sharding.batch_specs``, :func:`local_batch`) and runs the step
    above on them (the flash kernels per rank, on its local batch and
    heads, as the reference's ``shard_map`` runs them);
  * on a model axis > 1 (tensor parallelism) the model is this rank's
    block of the f32 master weights (``transformer.param_placement``,
    which the step carries as ``step.placement``),
    ``transformer.loss_fn(mesh=)`` runs the column- / row-parallel
    forward and the vocab-parallel CE, the gradients and both AdamW
    moments are this rank's blocks, and the clip reads the whole model's
    norm (``adamw.sharded_global_norm``).  The replicated leaves (the
    norms; the attention in sequence mode) get the same gradient on
    every rank by construction and take no model-axis reduction;
  * the f32 gradients and the loss are averaged over the data axis's
    group, and the finite flag is reduced with MIN over the whole world,
    so every rank takes the same update or the same skip.

Every arch trains on a model axis > 1: the GQA attention archs, MLA
(``q_b`` / ``kv_b`` / ``wo`` by heads; the latents and the rope key
whole, each entering the heads through ``copy_to_model``), the MoE
among them (TP-experts or
expert parallelism, ``models/moe.py``; its ``moe_aux`` term is part of
each data shard's loss, so it is averaged over the data group with the
loss and never summed over the model axis), the SSM mixers (every ``ssm``
leaf whole on every rank, its gradient the same bits on each, as the
norms') and the encoder-decoder (``batch["frames"]`` split over DP with
the tokens).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core.checkpoint import CheckpointConfig
from repro_torch.core.mixed_precision import (LossScale, get_policy,
                                              scaled_value_and_grad)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_mod
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
    resolved TrainConfig); ``step.placement`` is this rank's placement of
    the parameters and moments on ``mesh``
    (``transformer.param_placement``), as the reference returns its
    shardings beside its step."""
    tc = resolve_remat(cfg, tc, batch_sds, mesh=mesh)
    return build_train_step(cfg, tc, mesh=mesh), tc


def _dp_view(mesh):
    """``mesh`` as (data, model): its DP axes (pod, data) merged into one
    "data" axis of ``sharding.dp_size`` ranks.  Ranks lie row-major with
    the model axis innermost, so each rank keeps its place."""
    return mesh_mod.Mesh(data=shd.dp_size(mesh),
                         model=mesh.shape.get("model", 1))


def _data_group(cfg: ModelConfig, mesh):
    """The process group a step with ``mesh`` averages its gradients and
    loss over, or None (no reduction): the default group on a (data, 1)
    mesh whenever one is initialized, the data axis's group on a model
    axis > 1 (None where the data axis is 1).  Raises where ``cfg`` does
    not train on the mesh's model axis, and where the process group is
    missing or of another size."""
    if mesh is None:
        return None
    n_model = mesh.shape.get("model", 1)
    if n_model > 1:
        transformer.check_mesh(cfg, mesh)
    if not dist.is_initialized():
        if mesh.size > 1:
            kind = "tensor" if n_model > 1 else "data"
            raise RuntimeError(f"train step on {mesh}: {kind} parallelism "
                               f"needs an initialized process group")
        return None
    if dist.get_world_size() != mesh.size:
        raise RuntimeError(f"train step on {mesh}: the process group has "
                           f"{dist.get_world_size()} ranks, the mesh has "
                           f"{mesh.size}")
    if n_model == 1:
        return dist.group.WORLD
    return mesh_mod.axis_group(_dp_view(mesh), "data")


def local_batch(cfg: ModelConfig, batch: dict, mesh,
                rank: int | None = None) -> dict:
    """The rows of a global batch that rank ``rank`` (default: this
    process) trains on: each leaf split along the dim its
    ``sharding.batch_specs`` entry puts on the DP axes (axis 1 of
    M-RoPE's (3, B, S) positions, axis 0 of everything else), by the
    rank's data coordinate (the ranks of one model group take the same
    rows)."""
    n = shd.dp_size(mesh)
    at = mesh_mod.coords(_dp_view(mesh), rank)["data"]
    out = {}
    for name, spec in shd.batch_specs(cfg, batch, mesh).items():
        x = batch[name]
        d = next(i for i, e in enumerate(spec) if e is not None)
        if x.shape[d] % n:
            raise ValueError(f"batch leaf {name!r}: {x.shape[d]} rows do "
                             f"not split over {n} DP ranks")
        rows = x.shape[d] // n
        out[name] = x.narrow(d, at * rows, rows)
    return out


def build_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None):
    """-> ``train_step(model, opt_state, loss_scale, batch)`` returning
    ``(model, opt_state, loss_scale, metrics)``.

    ``model`` holds the f32 master weights with ``requires_grad`` on;
    the step updates them and ``opt_state`` in place.  ``metrics`` are
    0-d device tensors: loss, grads_finite, grad_norm, lr.  With a DP
    mesh (see the module docstring) ``batch`` is the global batch, every
    rank passes the same one, and the metrics are global; on a model axis
    > 1 ``model`` is this rank's block (``init_params(mesh=)``,
    ``bridge.load_jax_params(mesh=)``) and ``opt_state`` its moments
    (``adamw.init`` on its parameters).  The step carries the placement
    it trains (``transformer.param_placement``) as ``step.placement``."""
    policy = get_policy(tc.policy)
    if tc.accum < 1:
        raise ValueError(f"accum must be >= 1, got {tc.accum}")
    group = _data_group(cfg, mesh)
    specs = transformer.param_placement(cfg, mesh)
    sharded = None if specs is None else {
        n: any(e is not None for e in spec) for n, spec in specs.items()}
    reduce = group is not None or specs is not None

    def loss_for(model, mb):
        return transformer.loss_fn(model, cfg, mb, policy=policy,
                                   remat=tc.remat, mesh=mesh)

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
        """The DP mean of the loss and the f32 gradients over the data
        group, and the finite flag of every rank of the world (MIN), so
        all ranks step or skip together."""
        flag = finite.to(torch.int32)
        works = []
        if group is not None:
            grads = {k: g.contiguous() for k, g in grads.items()}
            works = [dist.all_reduce(g, group=group, async_op=True)
                     for g in grads.values()]
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=group)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        for w in works:
            w.wait()
        if group is not None:
            n = dist.get_world_size(group)
            for g in grads.values():
                g.div_(n)
            loss = loss / n
        return loss, grads, flag.bool()

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
        if not reduce:
            loss, grads, finite = compute_grads(model, ls, batch)
        else:
            loss, grads, finite = reduce_grads(*compute_grads(
                model, ls, local_batch(cfg, batch, mesh)))
        skip = ~finite if (tc.use_loss_scale or tc.skip_nonfinite) else None
        _, opt_state, metrics = adamw.update(
            tc.opt, grads, opt_state, params, decay=decay, skip=skip,
            sharded=sharded, mesh=mesh)
        new_ls = loss_scale.update(finite) if tc.use_loss_scale \
            else loss_scale
        metrics = {"loss": loss, "grads_finite": finite, **metrics}
        return model, opt_state, new_ls, metrics

    train_step.placement = specs
    return train_step


def init_loss_scale(tc: TrainConfig, device) -> LossScale:
    return LossScale.init(device=device) if tc.use_loss_scale \
        else LossScale.noop(device=device)
