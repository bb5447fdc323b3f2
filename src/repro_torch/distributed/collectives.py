"""Explicit collectives over ``torch.distributed`` process groups
(counterpart of ``repro.distributed.collectives``): the compressed DP
all-reduce, the sequence-parallel decode attention, and the two
reductions of tensor parallelism over the mesh's "model" axis.

The train step's own DP reduction is the plain f32 mean
(``train/train_step.py``), as the reference leaves it to XLA;
:func:`compressed_psum_grads` is the hand-rolled equivalent for gradient
compression over slow links, a library function as in the reference.

Where the reference's ``shard_map`` hands each device its block of a
global array, every rank here holds only its block (the model's shards,
the slot pool's), so these functions take this rank's blocks and the
``launch/mesh.py`` ``Mesh``, and find the process group of this rank's
model axis (``mesh.axis_group``).  A mesh whose model axis is 1, or no
mesh, communicates nothing.

  * :func:`reduce_from_model` -- the row-parallel sum (``wo``,
    ``w_down``, the vocab-parallel embedding): each rank's partial in its
    own dtype, summed in f32, the sum rounded back to that dtype.  Every
    rank gets the same bits.  Its backward is the identity: the sum's
    gradient is already whole on every rank.
  * :func:`copy_to_model` -- the identity on the replicated input of a
    column-parallel product (``wq`` / ``wk`` / ``wv`` in heads mode,
    ``w_gate`` / ``w_up``, the vocab-sharded head), whose backward sums
    the ranks' partial input gradients (f32, rounded back).  The pair is
    Megatron's f / g: every rank calls ``backward()`` on the same loss,
    so only a gradient that is a partial sum may be summed.
  * :func:`model_all_gather` -- vocab-sharded logits gathered whole on
    every rank before any host decision (serving; not differentiable).
  * :func:`sp_decode_attention` / :func:`sp_decode_attention_int8` --
    one-token decode with the cache's SEQUENCE dim sharded over the model
    axis: each rank's unnormalised softmax partials (m_i, l_i, o_i)
    merged by :func:`merge_partials` with one MAX and two SUM
    all-reduces over (B, H)-sized statistics, never the cache.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

from repro_torch.kernels.kvq import ops as kvq_ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim import compression


def rank_payload(grads: Mapping, seed: int, rank: int) -> dict:
    """The int8 payload rank ``rank`` puts on the wire for ``grads``:
    ``{name: (q, scale)}``, leaf ``i`` (sorted names) rounded with noise
    seeded from ``(seed, rank, i)``."""
    return {name: compression.quantize_int8(
                grads[name], compression.generator_for(grads[name], seed,
                                                       rank, i))
            for i, name in enumerate(sorted(grads))}


def compressed_psum_grads(grads: Mapping, group=None, seed: int = 0, *,
                          codec: str = "int8") -> dict:
    """Mean all-reduce of this rank's gradients over ``group`` (default:
    the whole world), int8 payloads.

    Each rank quantizes its OWN gradients to int8 with a rank-folded
    stochastic-rounding seed: decorrelated noise is what makes the mean
    unbiased (a shared seed would correlate the rounding errors and they
    would no longer average out).  The reduction runs on the dequantized
    values in f32, one ``all_reduce(SUM)`` over the leaves concatenated,
    divided by the group size; the int8 payload (:func:`rank_payload`,
    ``compression.payload_bytes``) is what would cross the links: bytes
    are accounted, the wire format is not changed.  Every rank gets the
    same mean."""
    if codec != "int8":
        raise ValueError(f"compressed_psum_grads: codec {codec!r}; only "
                         f"'int8' is reduced")
    rank = dist.get_rank(group)
    n = dist.get_world_size(group)
    names = sorted(grads)
    payload = rank_payload(grads, seed, rank)
    flat = torch.cat([compression.dequantize_int8(*payload[k]).reshape(-1)
                      for k in names])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= n
    out, at = {}, 0
    for k in names:
        m = grads[k].numel()
        out[k] = flat[at:at + m].reshape(grads[k].shape)
        at += m
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism over the "model" axis.
# ---------------------------------------------------------------------------
def model_axis(mesh, axis: str = "model"):
    """(process group, size, this rank's index) of ``axis``; (None, 1, 0)
    without a mesh or where the axis has size 1."""
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return None, 1, 0
    return (mesh_mod.axis_group(mesh, axis), mesh.shape[axis],
            mesh_mod.coords(mesh)[axis])


def all_reduce_f32(x: torch.Tensor, op, group) -> torch.Tensor:
    """``op`` over ``group`` of ``x`` as f32 (a new tensor; every rank gets
    the same bits)."""
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, op=op, group=group)
    return y


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    return all_reduce_f32(x, dist.ReduceOp.SUM, group).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh,
                  axis: str = "model") -> torch.Tensor:
    """``x`` itself in the forward; in the backward, the sum of every
    rank's gradient over ``axis`` (f32, rounded back to its dtype).  The
    identity without a model axis."""
    group, n, _ = model_axis(mesh, axis)
    if n == 1:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, mesh,
                      axis: str = "model") -> torch.Tensor:
    """Sum of every rank's ``x`` over ``axis``, in f32, rounded back to
    ``x.dtype`` (a new tensor, the same bits on every rank; ``x`` itself
    without a model axis).  The backward passes the gradient through."""
    group, n, _ = model_axis(mesh, axis)
    if n == 1:
        return x
    return _ReduceFromModel.apply(x, group)


def model_all_gather(x: torch.Tensor, mesh, dim: int = -1,
                     axis: str = "model") -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (a
    vocab-sharded logit block -> the whole vocab), exact: the blocks
    travel as f32."""
    group, n, _ = model_axis(mesh, axis)
    if n == 1:
        return x
    y = x.to(torch.float32).contiguous()
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, dim=dim).to(x.dtype)


# ---------------------------------------------------------------------------
# Sequence-parallel decode attention.
# ---------------------------------------------------------------------------
def merge_partials(o, m, l, *, amax=None, total=None):
    """The flash combine of softmax partials:

      m = max_i m_i;  l = sum_i l_i e^{m_i - m};
      out = sum_i o_i e^{m_i - m} / max(l, 1e-30)

    o (..., H, D) unnormalised, m and l (..., H), f32.  ``amax`` and
    ``total`` reduce over the shards: by default over a leading shard
    axis of stacked partials in one process; :func:`sp_decode_attention_int8`
    passes all-reduces over the model group.  A shard with no live
    position (m = NEG_INF, l = 0, o = 0) is weighted by exactly 0 against
    any live max."""
    amax = amax or (lambda t: t.amax(0))
    total = total or (lambda t: t.sum(0))
    m_all = amax(m)
    corr = torch.exp(m - m_all)
    l_all = total(l * corr)
    o_all = total(o * corr[..., None])
    return o_all / torch.clamp(l_all, min=1e-30)[..., None]


def _group_merge(o, m, l, group):
    return merge_partials(
        o, m, l, amax=lambda t: all_reduce_f32(t, dist.ReduceOp.MAX, group),
        total=lambda t: all_reduce_f32(t, dist.ReduceOp.SUM, group))


def _seq_offset(mesh, s_local: int, axis: str) -> tuple:
    group, n, r = model_axis(mesh, axis)
    if n == 1:
        raise ValueError(f"sequence-parallel decode needs a mesh whose "
                         f"{axis!r} axis is > 1, got {mesh}")
    return group, r * s_local


def sp_decode_attention(q, k_cache, v_cache, bias, mesh, *,
                        sm_scale: float, seq_axis: str = "model"):
    """Decode attention (the plain f32 form) with the KV sequence dim
    sharded over ``seq_axis`` (``repro.distributed.collectives``
    ``sp_decode_attention``): q (B, H, D) whole; k_cache, v_cache (B, H,
    S_l, D) this rank's positions ``[r S_l, (r+1) S_l)``; bias (B, S) the
    whole additive mask.  Returns (B, H, D) in q's dtype, the same on
    every rank."""
    s_l = k_cache.shape[2]
    group, off = _seq_offset(mesh, s_l, seq_axis)
    logits = torch.einsum("bhd,bhsd->bhs", q.float(),
                          k_cache.float()) * sm_scale
    logits = logits + bias[:, None, off:off + s_l]
    m_i = logits.amax(-1)
    p = torch.exp(logits - m_i[..., None])
    o_i = torch.einsum("bhs,bhsd->bhd", p, v_cache.float())
    return _group_merge(o_i, m_i, p.sum(-1), group).to(q.dtype)


def _write_local(cache, new, local_at, own):
    """Rows where ``own`` write ``new`` at their ``local_at`` slot of the
    sequence axis (dim 2), in place; the other rows keep their slot (no
    host sync: the rows' current values are written back)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cur = cache[rows, :, local_at]
    own = own.reshape((-1,) + (1,) * (cur.ndim - 1))
    cache[rows, :, local_at] = torch.where(own, new.to(cache.dtype), cur)


def sp_decode_attention_int8(q, k_q, k_s, v_q, v_s, write, write_at, mesh,
                             *, sm_scale: float, lengths=None, bias=None,
                             seq_axis: str = "model", splits: int = 1):
    """One-token GQA decode over an int8 cache whose SEQUENCE dim is
    sharded over ``seq_axis`` (``repro.distributed.collectives``
    ``sp_decode_attention_int8``): the serve pool's layout when the KV
    heads do not divide the model axis (``sharding.serve_kv_shard``).

    q (B, H, D) whole; k_q, v_q (B, Hkv, S_l, D) int8 and k_s, v_s
    (B, Hkv, S_l) f32: this rank's positions ``[r S_l, (r+1) S_l)``;
    write = (kq_new (B, Hkv, D) int8, ks_new (B, Hkv) f32, vq_new,
    vs_new); write_at (B,) global positions; ``lengths`` (B,) global
    lengths XOR ``bias`` (B, S) the whole additive mask.

    The token write lands only on the rank that owns ``write_at``, at the
    clamped local index, in place.  Attention is the cross-device twin of
    the split-K kernel: ``kvq_ops.decode_attention(partials=True)`` on
    this rank's shard (the kernel on the card, ``splits`` resolved on
    S_l; the plain version on the CPU) with local lengths ``clamp(len -
    r S_l, 0, S_l)`` or the bias's local columns, then
    :func:`merge_partials` over the group.  ``lengths >= 1`` (the
    engine's free-slot clamp) leaves every row a live shard.  Returns
    (out (B, H, D) f32, then the four cache shards, updated in place)."""
    if (lengths is None) == (bias is None):
        raise ValueError("sp_decode_attention_int8: exactly one of "
                         "lengths / bias")
    s_l = k_q.shape[2]
    group, off = _seq_offset(mesh, s_l, seq_axis)
    at = write_at.to(torch.int64)
    own = (at >= off) & (at < off + s_l)
    local_at = torch.clamp(at - off, 0, s_l - 1)
    for cache, new in zip((k_q, k_s, v_q, v_s), write):
        _write_local(cache, new, local_at, own)
    if lengths is not None:
        mask = dict(lengths=torch.clamp(lengths - off, 0, s_l)
                    .to(torch.int32))
    else:
        mask = dict(bias=bias[:, off:off + s_l].contiguous())
    o, m, l = kvq_ops.decode_attention(q, k_q, k_s, v_q, v_s,
                                       sm_scale=sm_scale, splits=splits,
                                       partials=True, **mask)
    return _group_merge(o, m, l, group), k_q, k_s, v_q, v_s
