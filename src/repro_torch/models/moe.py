"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``): a top-k
router with the Switch load-balance aux, then capacity dispatch (the
default, ``capacity_factor > 0``) or dropless dispatch
(``capacity_factor == 0``).

The reference computes the experts' products as ``einsum`` / ``ragged_dot``
outside any Pallas kernel; here they are ``torch.bmm`` (capacity) and one
matmul per expert's slice (dropless).  ``weights`` is a dict of the
layer's leaves, already in the compute dtype: ``router`` (D, E),
``w_gate`` / ``w_up`` (E, D, F), ``w_down`` (E, F, D) and, with shared
experts, ``shared_gate`` / ``shared_up`` (D, Fs), ``shared_down`` (Fs, D).

Every token of the call takes capacity, padding included: the serve
engine's bucket-padded prefill and its free decode slots are routed as
the reference routes them, so the same tokens overflow.  Data
parallelism needs nothing here: each rank runs this FFN on its own rows,
as the reference's ``shard_map`` runs it on each data shard.

Over a mesh's model axis (``mesh=``, the reference's ``shard_map`` path)
every rank routes all of the call's tokens with the replicated router and
holds its block of the experts, as ``sharding.param_specs`` places them:
TP-experts (``w_gate`` / ``w_up`` split on F, ``w_down`` on its F rows,
the shared experts on Fs) or, with ``expert_mode="ep"``, expert
parallelism (E / n whole experts a rank; the shared experts still split
on Fs).  :func:`expert_layout` reads which from the weights.  Each rank
computes its partial of the output, the shared experts' share included,
in x's dtype, and ``collectives.reduce_from_model`` sums the partials;
there is no all-to-all, as in the reference.  For the gradients, the
experts' input and the combine weights enter through
``collectives.copy_to_model`` (each rank's gradient of them is a
partial); the router's input does not (the router and the aux run whole
on every rank, so their gradient is whole already).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.distributed import collectives
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.layers import swiglu


def _part(name: str):
    """A profiler range over one part of the capacity FFN (``moe.router``,
    ``moe.dispatch``, ``moe.experts``, ``moe.combine``, ``moe.shared``),
    or of an encoder-decoder (``encdec.encoder``, ``encdec.cross_attn``,
    ``models/transformer.py``), opened only while a profiler records: a
    serve round's device time by part, read by chip_smoke.py's
    ``serve_variants`` and ``serve_encdec`` profiles."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


def router_topk(x: torch.Tensor, w_router: torch.Tensor, k: int):
    """x (T, D), w_router (D, E) -> (weights (T, k) f32, idx (T, k) int64,
    aux).  f32 logits, softmax, top-k, the weights renormalised over the
    k; aux is Switch's ``E * sum_e f_e * p_e``, with ``f`` the share of the
    T*k assignments each expert got (counted, no gradient) and ``p`` the
    mean router probability (differentiable)."""
    logits = x.float() @ w_router.float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    weights = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    e = w_router.shape[-1]
    f = torch.bincount(top_i.reshape(-1), minlength=e).float()
    f = f / f.sum().clamp_min(1.0)
    aux = e * (f * probs.mean(0)).sum()
    return weights, top_i, aux


def capacity(tokens: int, cfg) -> int:
    """Rows per expert of the capacity buffer for a call of ``tokens``
    tokens: ``T * k / E * capacity_factor`` rounded down to a multiple of
    8, at least 8 (the reference's formula, in Python floats; E is every
    expert, on a model axis too)."""
    m = cfg.moe
    return max(8, int(tokens * m.top_k / m.num_experts
                      * m.capacity_factor) // 8 * 8)


def dispatch_slots(top_i: torch.Tensor, e: int, cap: int):
    """Capacity dispatch of the flat (token, k) assignments to experts
    ``[0, e)``: each one's rank within its expert is the running count
    over the flat order (the reference's ``cumsum`` of one-hots), and the
    ranks at or past ``cap`` drop.  An index outside ``[0, e)`` (another
    rank's expert under expert parallelism, the indices shifted by this
    rank's first expert) counts for none and drops: the reference's
    ``in_range`` form.  Returns (dst (T*k,) rows of the (e * cap + 1, D)
    buffer, the last row taking every drop; keep (T*k,) bool)."""
    flat_e = top_i.reshape(-1)
    mine = (flat_e >= 0) & (flat_e < e)
    flat_e = flat_e.clamp(0, e - 1)
    oh = F.one_hot(flat_e, e) * mine[:, None]                 # (Tk, e)
    pos = (oh.cumsum(0) * oh).sum(-1) - 1                     # rank in expert
    keep = (pos < cap) & mine
    dst = torch.where(keep, flat_e * cap + pos,
                      torch.full_like(flat_e, e * cap))
    return dst, keep


def expert_layout(weights: dict, cfg, mesh) -> tuple[str | None, int]:
    """-> (mode, the first expert this rank holds): how ``weights`` are
    cut over ``mesh``'s model axis of n, read from this rank's
    ``w_gate`` and checked against ``cfg``: ``"ep"`` where it holds E / n
    whole experts (offset its model coordinate x E / n), ``"tp"`` where
    it holds every expert's F / n columns, ``(None, 0)`` without a model
    axis.  Raises where the weights are whole on a model axis (each rank
    would add the whole FFN) or cut otherwise than ``cfg.moe`` places
    them."""
    n = 1 if mesh is None else mesh.shape.get("model", 1)
    if n == 1:
        return None, 0
    r = mesh_mod.coords(mesh)["model"]
    m = cfg.moe
    e_l, f_l = weights["w_gate"].shape[0], weights["w_gate"].shape[-1]
    if m.expert_mode == "ep" and e_l * n == m.num_experts \
            and f_l == m.d_expert:
        return "ep", r * e_l
    if m.expert_mode == "tp" and f_l * n == m.d_expert \
            and e_l == m.num_experts:
        return "tp", 0
    raise ValueError(
        f"moe_ffn: w_gate block {tuple(weights['w_gate'].shape)} on a "
        f"model axis of {n} is not {cfg.arch_id}'s expert_mode="
        f"{m.expert_mode!r} block of ({m.num_experts}, D, {m.d_expert})")


def describe_layout(cfg, n: int) -> str:
    """The launchers' banner word for ``cfg``'s experts on a model axis of
    ``n``: ``tp`` or ``ep (E/n a rank)``."""
    m = cfg.moe
    return f"ep ({m.num_experts // n} a rank)" if m.expert_mode == "ep" \
        else "tp"


def _shared(weights: dict, xf: torch.Tensor) -> torch.Tensor:
    return swiglu(xf, weights["shared_gate"], weights["shared_up"],
                  weights["shared_down"])


def _combine(ys: torch.Tensor, w: torch.Tensor, t: int, k: int):
    """Sum each token's k weighted expert outputs.  The reference
    scatter-adds them (``.at[tok_idx].add`` with ``tok_idx`` sorted by
    token); here they are a (T, k, D) view summed over k: the same terms,
    deterministic on the card (no atomics), in another summation order."""
    return (ys * w.reshape(-1, 1).to(ys.dtype)).view(t, k, -1).sum(1)


def _route(weights: dict, x: torch.Tensor, cfg, mesh):
    """The router on every token of the call, whole on every rank ->
    (xe (T, D) the experts' input and w (T, k) the combine weights, both
    through ``copy_to_model``; top_i (T, k); aux)."""
    xf = x.reshape(-1, x.shape[-1])
    with _part("moe.router"):
        w, top_i, aux = router_topk(xf, weights["router"], cfg.moe.top_k)
    return (collectives.copy_to_model(xf, mesh),
            collectives.copy_to_model(w, mesh), top_i, aux)


def _finish(weights: dict, out, xe, x, cfg, mesh):
    """Add the shared experts' share (this rank's Fs columns on a model
    axis), cast to x's dtype, sum the ranks' partials."""
    if cfg.moe.num_shared:
        with _part("moe.shared"):
            out = out + _shared(weights, xe)
    out = out.reshape(x.shape).to(x.dtype)
    return collectives.reduce_from_model(out, mesh)


def moe_capacity(weights: dict, x: torch.Tensor, cfg, mesh=None,
                 offset: int = 0):
    """Capacity dispatch (the reference's ``_moe_capacity_local``): tokens
    scatter into a fixed (E, C, D) buffer, overflow drops, the experts run
    as one batched product, results gather back and combine with the
    router weights.  On a model axis the experts are this rank's block
    (``offset``: the first of its whole experts under expert
    parallelism).  Returns ((B, S, D) in x's dtype, aux)."""
    xe, w, top_i, aux = _route(weights, x, cfg, mesh)
    t, d = xe.shape
    k = cfg.moe.top_k
    e = weights["w_gate"].shape[0]
    cap = capacity(t, cfg)
    with _part("moe.dispatch"):
        dst, keep = dispatch_slots(top_i - offset, e, cap)
        keep_x = keep[:, None].to(xe.dtype)
        xs = xe.repeat_interleave(k, dim=0) * keep_x          # (Tk, D)
        # one spare row takes the drops (the reference's out-of-range
        # index under mode="drop"); only its value is undefined, and it is
        # cut off
        buf = xe.new_zeros((e * cap + 1, d)).index_copy(0, dst, xs)
        buf = buf[:e * cap].view(e, cap, d)
    with _part("moe.experts"):
        h = F.silu(torch.bmm(buf, weights["w_gate"])) \
            * torch.bmm(buf, weights["w_up"])
        ys = torch.bmm(h, weights["w_down"]).reshape(e * cap, d)
    with _part("moe.combine"):
        ys = ys[dst.clamp(max=e * cap - 1)] * keep_x.to(ys.dtype)
        out = _combine(ys, w, t, k)
    return _finish(weights, out, xe, x, cfg, mesh), aux


def moe_dropless(weights: dict, x: torch.Tensor, cfg, mesh=None,
                 offset: int = 0):
    """Dropless dispatch (the reference's ``_moe_local`` at
    ``capacity_factor == 0``): the T*k rows stably sorted by expert, one
    product per expert's slice (the reference's ``ragged_dot``; the group
    sizes come to the host), unsorted and combined with the router
    weights.  On a model axis the experts are this rank's block; under
    expert parallelism (``offset``) the rows of the other ranks' experts
    are skipped (zero in this rank's partial).  Returns ((B, S, D) in x's
    dtype, aux)."""
    xe, w, top_i, aux = _route(weights, x, cfg, mesh)
    t, d = xe.shape
    k = cfg.moe.top_k
    e = weights["w_gate"].shape[0]
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    xs = xe[flat_tok[order]]                                  # (Tk, D)
    sizes = torch.bincount(flat_e, minlength=cfg.moe.num_experts).tolist()
    parts, lo = [], 0
    for ex, n in enumerate(sizes):
        mine = 0 <= ex - offset < e
        if n and mine:
            xg = xs[lo:lo + n]
            h = F.silu(xg @ weights["w_gate"][ex - offset]) \
                * (xg @ weights["w_up"][ex - offset])
            parts.append(h @ weights["w_down"][ex - offset])
        elif n:
            parts.append(xs.new_zeros((n, d)))
        lo += n
    ys_sorted = torch.cat(parts)
    ys = torch.empty_like(ys_sorted).index_copy(0, order, ys_sorted)
    return _finish(weights, _combine(ys, w, t, k), xe, x, cfg, mesh), aux


def moe_ffn(weights: dict, x: torch.Tensor, cfg, mesh=None):
    """x (B, S, D) -> ((B, S, D), aux): capacity dispatch when
    ``cfg.moe.capacity_factor > 0`` (the default 1.25), else dropless.
    Without a model axis ``expert_mode`` is ignored, as in the reference;
    on one, ``weights`` are this rank's block (:func:`expert_layout`) and
    every rank returns the same sum of the partials.  Under expert
    parallelism at ``capacity_factor == 0`` the reference computes
    TP-experts on weights placed by expert; here each rank runs the
    dropless dispatch over its own experts: the same sum, another
    placement."""
    _, offset = expert_layout(weights, cfg, mesh)
    if cfg.moe.capacity_factor > 0:
        return moe_capacity(weights, x, cfg, mesh, offset)
    return moe_dropless(weights, x, cfg, mesh, offset)
