"""AdamW with decoupled weight decay, a warmup-cosine schedule and global
gradient clipping (counterpart of ``repro.optim.adamw``).

Plain functions on {parameter name: tensor} dicts, not ``torch.optim``:
the bias correction, the place of eps, the clip and the schedule are the
JAX package's (``adamw.py:36-96``), computed in f32.  ``update`` writes
the parameters and moments IN PLACE (the JAX version returns new trees):
at full width a second copy of the f32 parameters and both moments would
cost three times the parameter bytes.  Nothing in it syncs with the host:
a skipped step is a ``torch.where`` on the device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import collectives


@dataclasses.dataclass
class AdamWState:
    mu: dict          # {name: f32 tensor}, first moments
    nu: dict          # {name: f32 tensor}, second moments
    count: torch.Tensor  # 0-d int32: steps applied


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (0-d tensor): linear warmup, then cosine
    down to ``min_lr_frac`` of ``lr``."""
    step = step.float()
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init(params: dict) -> AdamWState:
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    dev = next(iter(params.values())).device
    return AdamWState(mu=zeros,
                      nu={n: torch.zeros_like(z) for n, z in zeros.items()},
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def jax_layout_decay_mask(params: dict) -> dict:
    """{parameter name: takes weight decay}, by the rank the leaf has in the
    JAX layout.  The JAX package decays every leaf of rank >= 2
    (``adamw.py:77``); there the per-layer weights under ``blocks.`` (and
    an encoder's under ``enc_blocks.``) are stacked, so the (D,) norm
    weights and biases become (L, D) and ARE decayed while ``final_norm``
    and ``enc_norm`` (D,) are not.  The port's per-layer tensors must
    follow that rank, not their own.

    For the transformer only: the JAX CNN keeps ``blocks`` as a list of
    unstacked per-block dicts (``repro/models/cnn.py``), so its GroupNorm
    (C,) scales are rank 1 and NOT decayed.  The CNN path passes no mask,
    and ``update`` applies each leaf's own rank."""
    return {n: p.ndim + n.startswith(("blocks.", "enc_blocks.")) >= 2
            for n, p in params.items()}


def _sum_squares(tensors) -> torch.Tensor:
    return torch.stack([t.float().square().sum() for t in tensors]).sum()


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(_sum_squares(tensors))


def sharded_global_norm(grads: dict, sharded: dict, mesh) -> torch.Tensor:
    """The global norm of a model whose leaves named True in ``sharded``
    are this rank's blocks over ``mesh``'s model axis: their squares
    summed over the model group (one 0-d all-reduce), plus the
    replicated leaves' squares counted once.  Every rank of the group
    gets the same bits."""
    split = [g for n, g in grads.items() if sharded[n]]
    whole = [g for n, g in grads.items() if not sharded[n]]
    sq = _sum_squares(split) if split else torch.zeros(
        (), device=next(iter(grads.values())).device)
    sq = collectives.reduce_from_model(sq, mesh)
    return torch.sqrt(sq + _sum_squares(whole) if whole else sq)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, state: AdamWState, params: dict,
           *, decay: dict | None = None, skip: torch.Tensor | None = None,
           sharded: dict | None = None, mesh=None):
    """One step -> (params, state, {"grad_norm", "lr"}); ``params`` and the
    moments are updated in place and returned.  On a mesh's model axis
    (``mesh``, with ``sharded``: {name: True where the leaf is this rank's
    block}) ``params``, ``grads`` and the moments are this rank's blocks
    (the reference's ``opt_shard``: each moment placed as its parameter),
    and the clip reads :func:`sharded_global_norm`, the whole model's
    norm, so every rank clips by the same factor.

    ``decay`` ({name: bool}) says which parameters take weight decay;
    default: those of rank >= 2, the JAX rule, which is right wherever
    the port's tensors have the JAX layout's ranks (the CNN).  The port's
    transformer, whose per-layer tensors are unstacked where the JAX
    package's are stacked, passes the JAX-layout ranks
    (:func:`jax_layout_decay_mask`).  ``skip`` (0-d bool tensor, True =
    skip) leaves parameters, moments and the step count as they were."""
    gnorm = global_norm(grads.values()) if sharded is None \
        else sharded_global_norm(grads, sharded, mesh)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else 1.0
    count = state.count + 1
    lr = schedule(cfg, state.count)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=count.device),
                        count.float())
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=count.device),
                        count.float())
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state.mu[name], state.nu[name]
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g.square()
        step_ = lr * (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        wd = cfg.weight_decay if (p.ndim >= 2 if decay is None
                                  else decay[name]) else 0.0
        p2 = (p.float() * (1 - lr * wd) - step_).to(p.dtype)
        if skip is not None:
            p2 = torch.where(skip, p, p2)
            m2 = torch.where(skip, m, m2)
            v2 = torch.where(skip, v, v2)
        p.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)
    state.count = count if skip is None else torch.where(skip, state.count,
                                                         count)
    return params, state, {"grad_norm": gnorm, "lr": lr}
