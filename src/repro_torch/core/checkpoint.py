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

Policies: ``full`` and ``nothing`` save nothing inside a segment (the
paper's S-C); ``none`` saves everything, so nothing is recomputed.  The
JAX package's ``dots`` / ``dots_nobatch`` policies and ``save_names``
(which save chosen intermediates inside a segment) are not ported yet
and raise.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.plan.solver import RematPlan

#: policy name -> whether a segment under it is recomputed in the backward
POLICIES = {"full": True, "nothing": True, "none": False}
_NOT_PORTED = ("dots", "dots_nobatch")


def resolve_policy(policy: str | None,
                   save_names: Sequence[str] = ()) -> bool:
    """True if a segment under ``policy`` is recomputed (saves nothing
    inside), False if it keeps every intermediate (``none``)."""
    if save_names or policy in _NOT_PORTED:
        what = f"save_names {tuple(save_names)}" if save_names else \
            f"remat policy {policy!r}"
        raise NotImplementedError(
            f"{what} is not ported yet: it saves chosen intermediates inside "
            f"a segment and comes with a later slice of the port (ROADMAP.md "
            f"lists it); use 'full' or 'none'")
    if policy is None:
        return True
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; have "
                         f"{sorted(POLICIES) + list(_NOT_PORTED)}")
    return POLICIES[policy]


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """How S-C is applied to a layer stack -- the single remat entry point.

    enabled:       master switch (False == the paper's standard pipeline).
    policy:        intra-segment policy name (see ``POLICIES``).
    save_names:    not ported yet; must stay empty.
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

    def segment_policy(self, j: int) -> bool:
        """Whether plan segment ``j`` is recomputed.  A plan's own policy
        (scalar or per segment) wins over ``self.policy``."""
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


def _remat(fn: Callable, recompute: bool) -> Callable:
    """``fn`` whose intermediates are recomputed in the backward pass
    (only its inputs are saved), or ``fn`` itself.  Without autograd
    (serving) nothing is saved either way, so ``fn`` runs as it is."""
    if not recompute:
        return fn

    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
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
    recompute = resolve_policy(policy, save_names)

    segments = []
    for j, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        if lo == hi:
            continue
        seg = _chain(lambda x, f: f(x), layer_fns[lo:hi])
        segments.append((seg, seg_policies[j] if seg_policies is not None
                         else recompute))

    def apply(x):
        for seg, rc in segments[:-1]:
            x = _remat(seg, rc)(x)
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
