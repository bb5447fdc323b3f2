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
the reference routes them, so the same tokens overflow.  The mesh paths
(TP-experts under ``shard_map``, expert parallelism) are not ported yet:
they come with slice G's MoE TP / EP part.  Data
parallelism needs none of them: each rank runs this FFN on its own rows.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.profiler import record_function

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
    8, at least 8 (the reference's formula, in Python floats)."""
    m = cfg.moe
    return max(8, int(tokens * m.top_k / m.num_experts
                      * m.capacity_factor) // 8 * 8)


def dispatch_slots(top_i: torch.Tensor, e: int, cap: int):
    """Capacity dispatch of the flat (token, k) assignments: each one's
    rank within its expert is the running count over the flat order (the
    reference's ``cumsum`` of one-hots), and the ranks at or past ``cap``
    drop.  Returns (dst (T*k,) rows of the (E * cap + 1, D) buffer, the
    last row taking every drop; keep (T*k,) bool)."""
    flat_e = top_i.reshape(-1)
    oh = F.one_hot(flat_e, e)                                 # (Tk, E)
    pos = (oh.cumsum(0) * oh).sum(-1) - 1                     # rank in expert
    keep = pos < cap
    dst = torch.where(keep, flat_e * cap + pos,
                      torch.full_like(flat_e, e * cap))
    return dst, keep


def _shared(weights: dict, xf: torch.Tensor) -> torch.Tensor:
    return swiglu(xf, weights["shared_gate"], weights["shared_up"],
                  weights["shared_down"])


def _combine(ys: torch.Tensor, w: torch.Tensor, t: int, k: int):
    """Sum each token's k weighted expert outputs.  The reference
    scatter-adds them (``.at[tok_idx].add`` with ``tok_idx`` sorted by
    token); here they are a (T, k, D) view summed over k: the same terms,
    deterministic on the card (no atomics), in another summation order."""
    return (ys * w.reshape(-1, 1).to(ys.dtype)).view(t, k, -1).sum(1)


def moe_capacity(weights: dict, x: torch.Tensor, cfg):
    """Capacity dispatch (the reference's ``_moe_capacity_local``): tokens
    scatter into a fixed (E, C, D) buffer, overflow drops, the experts run
    as one batched product, results gather back and combine with the
    router weights.  Returns ((B, S, D) in x's dtype, aux)."""
    m = cfg.moe
    b, s, d = x.shape
    t, k = b * s, m.top_k
    xf = x.reshape(t, d)
    with _part("moe.router"):
        w, top_i, aux = router_topk(xf, weights["router"], k)
    e = weights["w_gate"].shape[0]
    cap = capacity(t, cfg)
    with _part("moe.dispatch"):
        dst, keep = dispatch_slots(top_i, e, cap)
        keep_x = keep[:, None].to(xf.dtype)
        xs = xf.repeat_interleave(k, dim=0) * keep_x          # (Tk, D)
        # one spare row takes the drops (the reference's out-of-range
        # index under mode="drop"); only its value is undefined, and it is
        # cut off
        buf = xf.new_zeros((e * cap + 1, d)).index_copy(0, dst, xs)
        buf = buf[:e * cap].view(e, cap, d)
    with _part("moe.experts"):
        h = F.silu(torch.bmm(buf, weights["w_gate"])) \
            * torch.bmm(buf, weights["w_up"])
        ys = torch.bmm(h, weights["w_down"]).reshape(e * cap, d)
    with _part("moe.combine"):
        ys = ys[dst.clamp(max=e * cap - 1)] * keep_x.to(ys.dtype)
        out = _combine(ys, w, t, k)
    if m.num_shared:
        with _part("moe.shared"):
            out = out + _shared(weights, xf)
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_dropless(weights: dict, x: torch.Tensor, cfg):
    """Dropless dispatch (the reference's ``_moe_local`` at
    ``capacity_factor == 0``): the T*k rows stably sorted by expert, one
    product per expert's slice (the reference's ``ragged_dot``; the group
    sizes come to the host), unsorted and combined with the router
    weights.  Returns ((B, S, D) in x's dtype, aux)."""
    m = cfg.moe
    b, s, d = x.shape
    t, k = b * s, m.top_k
    xf = x.reshape(t, d)
    w, top_i, aux = router_topk(xf, weights["router"], k)
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    xs = xf[flat_tok[order]]                                  # (Tk, D)
    sizes = torch.bincount(flat_e, minlength=m.num_experts).tolist()
    parts, lo = [], 0
    for ex, n in enumerate(sizes):
        if n:
            xe = xs[lo:lo + n]
            h = F.silu(xe @ weights["w_gate"][ex]) \
                * (xe @ weights["w_up"][ex])
            parts.append(h @ weights["w_down"][ex])
        lo += n
    ys_sorted = torch.cat(parts)
    ys = torch.empty_like(ys_sorted).index_copy(0, order, ys_sorted)
    out = _combine(ys, w, t, k)
    if m.num_shared:
        out = out + _shared(weights, xf)
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_ffn(weights: dict, x: torch.Tensor, cfg, mesh=None):
    """x (B, S, D) -> ((B, S, D), aux) on one device: capacity dispatch
    when ``cfg.moe.capacity_factor > 0`` (the default 1.25), else
    dropless."""
    if mesh is not None or cfg.moe.expert_mode == "ep":
        raise NotImplementedError(
            "moe_ffn: the mesh paths (TP-experts, expert_mode='ep') are "
            "not ported yet; they come with slice G's MoE TP / EP part "
            "(data parallelism runs this FFN per rank)")
    if cfg.moe.capacity_factor > 0:
        return moe_capacity(weights, x, cfg)
    return moe_dropless(weights, x, cfg)
