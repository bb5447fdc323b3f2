"""Sequential-checkpoint (S-C) training, the paper's gradient-flow
optimisation (counterpart of ``repro.core.checkpoint``).

A layer stack runs as a list of segments; only each segment's input is
stored, and everything inside it is recomputed during the backward pass.
The JAX package does this with ``jax.checkpoint`` over a ``lax.scan``; the
port runs ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``
over segments of a Python loop of blocks.

  * ``CheckpointConfig`` -- the single remat entry point: on/off, the
    policy, a uniform ``segment_size`` or a solved ``RematPlan``.
  * ``remat_scan``       -- S-C over a stack of per-layer blocks.
  * ``checkpoint_sequential`` -- S-C over an explicit list of layer
    functions (the paper's algorithm; every segment but the last).
  * ``optimal_segments`` -- the placement DP (paper Fig. 11).
  * ``checkpoint_name``  -- tag a tensor for ``save_names``.

Policies (``POLICIES``), as in the JAX package: ``full`` and ``nothing``
save nothing inside a segment (the paper's S-C); ``none`` saves
everything, so nothing is recomputed; ``dots`` saves the outputs of the
matrix products (``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``) and
``dots_nobatch`` those without a batch dimension (``mm``, ``addmm``), as
XLA's ``dots_saveable`` / ``dots_with_no_batch_dims_saveable`` do; and
``save_names`` saves the tensors tagged with :func:`checkpoint_name`, on
top of the base policy.  The selective ones run through
``torch.utils.checkpoint``'s selective-checkpoint contexts: every other
operator is recomputed.  The flash op is one operator to the dispatcher
(``kernels/flash/ops.py`` ``_fwd_op``), as the Pallas call is one
primitive to JAX, so no policy saves what is inside it.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Callable, Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.plan.solver import RematPlan, min_peak_boundaries

_aten = torch.ops.aten
#: policy name -> the operators whose outputs a recomputed segment keeps,
#: or None: the segment is not recomputed at all (``none``)
POLICIES: dict[str, frozenset | None] = {
    "full": frozenset(),
    "nothing": frozenset(),
    "none": None,
    "dots": frozenset({_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}),
    "dots_nobatch": frozenset({_aten.mm, _aten.addmm}),
}


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _name_op(x: torch.Tensor, name: str) -> torch.Tensor:
    # an operator may not return an alias of its input: the tag is a copy
    return x.clone()


@_name_op.register_fake
def _(x, name):
    return torch.empty_like(x)


torch.library.register_autograd(
    "repro_torch::checkpoint_name",
    lambda ctx, grad: (grad, None))


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` tagged ``name`` for a ``save_names`` policy (the counterpart
    of ``jax.ad_checkpoint.checkpoint_name``).  The tag costs a copy of
    ``x``, so callers tag only when a policy asks for names
    (``CheckpointConfig.tags``)."""
    return _name_op(x, name)


@dataclasses.dataclass(frozen=True)
class SavePolicy:
    """What a recomputed segment keeps: the outputs of ``ops`` and the
    tensors tagged with one of ``names``.  Empty: it keeps nothing (the
    paper's S-C)."""

    ops: frozenset = frozenset()
    names: frozenset = frozenset()

    def __bool__(self) -> bool:
        return bool(self.ops or self.names)

    def decide(self, ctx, op, *args, **kwargs) -> CheckpointPolicy:
        if op.overloadpacket in self.ops or (
                op is torch.ops.repro_torch.checkpoint_name.default
                and args[1] in self.names):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE


def resolve_policy(policy: str | None,
                   save_names: Sequence[str] = ()) -> SavePolicy | None:
    """A policy name -> what a segment under it keeps (:class:`SavePolicy`),
    or None when it is not recomputed (``none``).  ``save_names``
    composes with the base policy: the tagged tensors are kept IN
    ADDITION to what the base keeps."""
    if policy is None:
        policy = "full"
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; have "
                         f"{sorted(POLICIES)}")
    ops = POLICIES[policy]
    if ops is None:                     # saves everything: names add nothing
        return None
    return SavePolicy(ops, frozenset(save_names))


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """How S-C is applied to a layer stack -- the single remat entry point.

    enabled:       master switch (False == the paper's standard pipeline).
    policy:        intra-segment policy name (see ``POLICIES``).
    save_names:    tags (:func:`checkpoint_name`) whose tensors a segment
                   keeps on top of ``policy``.
    segment_size:  uniform fallback: blocks per remat segment (1 = remat
                   every block).  Ignored when ``plan`` is set.
    plan:          a :class:`RematPlan` -- possibly non-uniform segment
                   boundaries and per-segment policies.
    """

    enabled: bool = True
    policy: str = "full"
    save_names: tuple[str, ...] = ()
    segment_size: int = 1
    plan: RematPlan | None = None

    def wrap(self, fn: Callable) -> Callable:
        """``fn`` run under S-C when enabled (whole-function remat)."""
        if not self.enabled:
            return fn
        return _remat(fn, resolve_policy(self.policy, self.save_names))

    @property
    def tags(self) -> frozenset:
        """The tags a model must apply (:func:`checkpoint_name`): those of
        ``save_names`` when some segment is recomputed, else none (a tag
        is a copy, and only a recomputed segment keeps it selectively)."""
        if not (self.enabled and self.save_names):
            return frozenset()
        n = self.plan.n_segments if self.plan is not None else 1
        if all(self.segment_policy(j) is None for j in range(n)):
            return frozenset()                  # "none" everywhere
        return frozenset(self.save_names)

    def segment_policy(self, j: int) -> SavePolicy | None:
        """What plan segment ``j`` keeps (:func:`resolve_policy`).  A
        plan's own policy (scalar or per segment) wins over
        ``self.policy``; ``save_names`` composes on top either way."""
        if self.plan is not None:
            return resolve_policy(self.plan.segment_policy(j),
                                  self.save_names)
        return resolve_policy(self.policy, self.save_names)

    def validated_plan(self, n_layers: int) -> RematPlan | None:
        """The plan, checked against the actual chain depth."""
        if self.plan is None:
            return None
        if self.plan.n_layers != n_layers:
            raise ValueError(
                f"RematPlan was solved for {self.plan.n_layers} layers but "
                f"the model has {n_layers}; re-run the planner "
                f"(plan source: {self.plan.source!r})")
        return self.plan


def _remat(fn: Callable, keep: SavePolicy | None) -> Callable:
    """``fn`` whose intermediates are recomputed in the backward pass
    except what ``keep`` names (only its inputs are saved when ``keep`` is
    empty), or ``fn`` itself when ``keep`` is None.  Without autograd
    (serving) nothing is saved either way, so ``fn`` runs as it is."""
    if keep is None:
        return fn
    kw = {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, keep.decide)} if keep else {}

    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False, **kw, **kwargs)
    return run


def _chain(body: Callable, blocks: Sequence) -> Callable:
    def seg(carry):
        for blk in blocks:
            carry = body(carry, blk)
        return carry
    return seg


# ---------------------------------------------------------------------------
# Explicit layer-list form (the paper's algorithm: segments of a Sequential).
# ---------------------------------------------------------------------------
def checkpoint_sequential(
    layer_fns: Sequence[Callable[[Any], Any]],
    num_segments: int = 0,
    *,
    policy: str | None = "full",
    boundaries: Sequence[int] | None = None,
    plan: RematPlan | None = None,
    save_names: Sequence[str] = (),
) -> Callable[[Any], Any]:
    """Compose ``layer_fns`` into one function with S-C applied.

    Layers are grouped into ``num_segments`` contiguous segments, at the
    explicit ``boundaries``, or per a solved :class:`RematPlan` (whose
    policy then overrides ``policy``).  Every segment but the last is
    recomputed in the backward pass: its input is saved, its
    intermediates are not.  The last one's activations feed the loss
    directly and would be recomputed at once anyway."""
    n = len(layer_fns)
    seg_policies = None
    if plan is not None:
        if plan.n_layers != n:
            raise ValueError(
                f"RematPlan solved for {plan.n_layers} layers applied to a "
                f"{n}-layer chain (plan source: {plan.source!r})")
        bounds = [0, *plan.boundaries, n]
        seg_policies = [resolve_policy(plan.segment_policy(j), save_names)
                        for j in range(plan.n_segments)]
    elif boundaries is None:
        num_segments = max(1, min(num_segments, n))
        # even split, the convention of torch.utils.checkpoint_sequential
        bounds = [round(i * n / num_segments)
                  for i in range(num_segments + 1)]
    else:
        bounds = [0, *sorted(boundaries), n]
    keep = resolve_policy(policy, save_names)

    segments = []
    for j, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        if lo == hi:
            continue
        seg = _chain(lambda x, f: f(x), layer_fns[lo:hi])
        segments.append((seg, seg_policies[j] if seg_policies is not None
                         else keep))

    def apply(x):
        for seg, seg_keep in segments[:-1]:
            x = _remat(seg, seg_keep)(x)
        return segments[-1][0](x)

    return apply


# ---------------------------------------------------------------------------
# Block-stack form: S-C over the per-layer blocks of a model.
# ---------------------------------------------------------------------------
def _largest_divisor_leq(n: int, k: int) -> int:
    """Largest d with d | n and d <= k (>= 1)."""
    for d in range(min(n, k), 1, -1):
        if n % d == 0:
            return d
    return 1


def remat_scan(body: Callable[[Any, Any], Any], carry: Any, blocks: Sequence,
               *, config: CheckpointConfig = CheckpointConfig()):
    """Run ``carry = body(carry, block)`` over ``blocks`` with S-C applied,
    the counterpart of the JAX package's ``lax.scan`` form.

    Three granularities, selected by ``config``:

      * per block (default): every block is its own remat segment;
      * uniform ``segment_size``: consecutive groups of that many blocks,
        one checkpoint per group; a size that does not divide the depth
        falls back to the largest divisor below it, with a warning;
      * a solved ``config.plan``: its (possibly non-uniform) segments,
        each under its own policy; every segment is recomputed, and an
        empty plan (no boundaries) runs without remat.
    """
    blocks = list(blocks)
    n = len(blocks)
    if config.enabled and config.plan is not None:
        plan = config.validated_plan(n)
        if not plan.boundaries:
            return _chain(body, blocks)(carry)
        for j, (lo, hi) in enumerate(plan.segments()):
            carry = _remat(_chain(body, blocks[lo:hi]),
                           config.segment_policy(j))(carry)
        return carry

    seg = config.segment_size if config.enabled else 1
    if seg > 1 and n % seg:
        # a segment size is a memory knob, not a semantic one, but silently
        # degrading to per-block storage defeats its purpose: warn
        new_seg = _largest_divisor_leq(n, seg)
        warnings.warn(
            f"remat_scan: segment_size={seg} does not divide {n} scanned "
            f"layers; using largest divisor {new_seg} (use a RematPlan for "
            f"non-uniform segments)", stacklevel=2)
        seg = new_seg
    seg = max(1, seg)
    for lo in range(0, n, seg):
        carry = config.wrap(_chain(body, blocks[lo:lo + seg]))(carry)
    return carry


# ---------------------------------------------------------------------------
# Optimal checkpoint placement (paper Fig. 11, formalized).
# ---------------------------------------------------------------------------
def optimal_segments(activation_bytes: Sequence[int],
                     num_checkpoints: int) -> list[int]:
    """Checkpoint boundaries minimizing peak stored activation bytes.

    ``activation_bytes[i]`` is the size of layer ``i``'s output (a
    candidate checkpoint site).  Peak memory under S-C is modelled as the
    stored checkpoints plus the largest segment's recompute live set (the
    sum of its internal activations): the paper's "checkpoint the narrow
    middle layer" advice as a DP.  Returns sorted boundary indices
    (exclusive of 0 and n).  The DP lives in ``repro_torch.plan.solver``."""
    return min_peak_boundaries(activation_bytes, num_checkpoints)


def activation_bytes_of(fn: Callable, *args, **kwargs) -> int:
    """Bytes of ``fn``'s output tensors, from a run on ``device="meta"``
    copies of the tensor arguments (shapes and dtypes only, as
    ``jax.eval_shape`` gives them): nothing is allocated."""
    from repro_torch.plan.profile import _meta

    def meta(x):
        return _meta(x) if isinstance(x, torch.Tensor) else x
    with torch.no_grad():
        out = fn(*map(meta, args), **{k: meta(v) for k, v in kwargs.items()})
    leaves = torch.utils._pytree.tree_leaves(out)
    return sum(x.numel() * x.element_size() for x in leaves
               if isinstance(x, torch.Tensor))
