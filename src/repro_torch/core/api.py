"""One-line OpTorch-style wrappers: ``scmodel = sc(model)`` etc.
(counterpart of ``repro.core.api``).

The paper advertises single-command composition of its pipelines; these
wrap an apply function ``apply_fn(params, *args)`` whose ``params`` and
arguments are tensors or dicts / lists / tuples of them (for a module,
``torch.func.functional_call`` gives such a function).
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core.checkpoint import CheckpointConfig
from repro_torch.core.mixed_precision import Policy, get_policy


def _cast(tree, dtype):
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree


def sc(apply_fn: Callable, *, policy: str = "full",
       save_names=()) -> Callable:
    """Sequential-checkpoint an apply function (whole-function remat)."""
    return CheckpointConfig(policy=policy,
                            save_names=tuple(save_names)).wrap(apply_fn)


def mp(apply_fn: Callable, *, policy: str | Policy = "bf16") -> Callable:
    """Mixed-precision an apply function: params and inputs are cast to the
    compute dtype on entry (autograd ops, so gradients reach f32 master
    params in f32), outputs cast to the output dtype."""
    pol = get_policy(policy) if isinstance(policy, str) else policy

    @functools.wraps(apply_fn)
    def wrapped(params, *args, **kwargs):
        out = apply_fn(_cast(params, pol.compute_dtype),
                       *_cast(args, pol.compute_dtype), **kwargs)
        return _cast(out, pol.output_dtype)

    return wrapped


def sc_mp(apply_fn: Callable, *, remat_policy: str = "full",
          mp_policy: str = "bf16") -> Callable:
    """The paper's best FP-mixed pipeline: S-C and M-P composed."""
    return sc(mp(apply_fn, policy=mp_policy), policy=remat_policy)
