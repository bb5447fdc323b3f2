"""GQA attention for prefill and cached decode (counterpart of
``repro.models.attention``, dense branch).

Prefill and training always go through the flash op (``kernels/flash``):
the CUDA kernels on the card, their plain versions on the CPU; it is
differentiable, so ``loss.backward()`` runs the flash backward.  Each layer
gets its window as a Python int, so windowed and global layers both reach
the flash kernel.  Decode writes the new token into the cache in place and
reads the cache through ``kernels/kvq.decode_attention`` (quantized) or
the plain masked softmax (unquantized), masked by length for a full-causal
layer and for a rolling window buffer (the two-tier cache,
``transformer.decode_step_two_tier``), and by a dense (B, S) bias for a
window band over a full-length cache.  MLA, cross-attention and the
sequence-sharded cache come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.kvq import ops as kvq_ops
from repro_torch.kernels.kvq.ref import masked_decode_logits
from repro_torch.kernels.tiling import NEG_INF
from repro_torch.models.layers import apply_rope


def attn_block(p, x, cfg, *, positions, window: int = 0, resid_dtype=None):
    """x: (B, S, D_model); p holds wq/wk/wv/wo, cast to ``x.dtype`` here.
    Returns (out, (k, v)) with k, v (B, S, Hkv, hd) after RoPE.
    ``resid_dtype`` is the storage dtype of the flash op's saved (q, k, v,
    o) under autograd (``Policy.flash_resid_dtype``)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    dt = x.dtype
    q = (x @ p.wq.to(dt)).reshape(b, s, h, hd)
    k = (x @ p.wk.to(dt)).reshape(b, s, hkv, hd)
    v = (x @ p.wv.to(dt)).reshape(b, s, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    out = flash_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal=True,
                                    window=window, resid_dtype=resid_dtype)
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return out @ p.wo.to(dt), (k, v)


def _write_token(cache, new, at):
    """Write one token into the S axis of a per-layer cache leaf, IN PLACE.

    cache: (B, Hkv, S, hd) or (B, Hkv, S); new: (B, Hkv, hd) / (B, Hkv);
    at: 0-d int (every row writes the same slot) or (B,) int (each row at
    its own length).  The JAX version returns an updated copy; the port
    writes into the pool's buffer on purpose, so a decode step moves one
    token per row instead of copying the cache.  Indices clamp to the last
    slot, as ``dynamic_update_slice`` does."""
    s = cache.shape[2]
    at = at.clamp(0, s - 1)
    if at.ndim == 0:
        cache[:, :, at] = new.to(cache.dtype)
    else:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, :, at] = new.to(cache.dtype)
    return cache


def decode_mask(pos, b: int, s_max: int, window: int):
    """The decode mask of one layer over a non-rolling cache of ``s_max``
    slots: (lengths (B,) int32, None) for a full-causal layer (window <= 0),
    or (None, bias (B, S) f32) for a window band, which lengths cannot
    express: 0 where ``pos - window < slot <= pos``, -1e30 elsewhere (the
    JAX package's ``attention.py:334-352``)."""
    if window <= 0:
        return (pos + 1).to(torch.int32).expand(b).contiguous(), None
    kv_pos = torch.arange(s_max, device=pos.device)
    pos_col = pos[:, None] if pos.ndim == 1 else pos     # broadcasts vs (., S)
    valid = (kv_pos[None, :] <= pos_col) & (kv_pos[None, :] > pos_col - window)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    return None, bias.expand(b, s_max).contiguous()


def rolling_mask(pos, b: int, s_max: int):
    """The decode mask of a rolling buffer of ``s_max`` slots (the two-tier
    cache's window layers): (lengths = min(pos + 1, S) (B,) int32, None).
    Every filled slot is in the window by construction, so no bias."""
    return (torch.clamp(pos + 1, max=s_max).to(torch.int32).expand(b)
            .contiguous(), None)


def attn_decode(p, x_t, cfg, cache_k, cache_s_k, cache_v, cache_s_v, pos,
                *, window: int = 0, mask=None, quantized: bool = True,
                splits: int = 1, rolling: bool = False):
    """One-token GQA decode against a per-layer cache.

    x_t: (B, D_model); cache_k/v (B, Hkv, S, hd) int8 (or the compute dtype
    when not quantized, scales unused); pos: 0-d int32 position, or (B,)
    int32 per-row positions (slot-pooled serving: each row rotates, writes
    and masks at its own position).  ``window`` <= 0 masks by length,
    ``pos + 1``; a window > 0 masks by the dense bias of
    :func:`decode_mask`.  ``rolling``: the cache is a circular buffer of
    its S slots (a window layer of the two-tier cache): the token is
    written at ``pos % S`` and masked by :func:`rolling_mask`'s lengths.
    ``mask`` is that (lengths, bias) pair when the caller already built it
    for this window and position (a decode step builds one for all the
    layers that share a window).  The cache leaves are updated in place
    and returned.  Returns (attn_out (B, D_model), (k, k_scale, v,
    v_scale))."""
    b, _ = x_t.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    per_row = pos.ndim == 1
    q = (x_t @ p.wq).reshape(b, 1, h, hd)
    k_t = (x_t @ p.wk).reshape(b, 1, hkv, hd)
    v_t = (x_t @ p.wv).reshape(b, 1, hkv, hd)
    pos_arr = (pos[:, None] if per_row else pos).expand(b, 1)
    q = apply_rope(q, pos_arr, cfg.rope_theta, cfg.rope_fraction)[:, 0]
    k_new = apply_rope(k_t, pos_arr, cfg.rope_theta, cfg.rope_fraction)[:, 0]
    v_new = v_t[:, 0]
    s_max = cache_k.shape[2]
    if mask is None:
        mask = rolling_mask(pos, b, s_max) if rolling else decode_mask(
            pos, b, s_max, window)
    lengths, bias = mask
    at = pos % s_max if rolling else pos

    if quantized:
        kq_new, ks_new = kvq_ops.quantize_kv(k_new)
        vq_new, vs_new = kvq_ops.quantize_kv(v_new)
        _write_token(cache_k, kq_new, at)
        _write_token(cache_v, vq_new, at)
        _write_token(cache_s_k, ks_new, at)
        _write_token(cache_s_v, vs_new, at)
        out = kvq_ops.decode_attention(q, cache_k, cache_s_k, cache_v,
                                       cache_s_v, lengths=lengths, bias=bias,
                                       splits=splits)
    else:
        _write_token(cache_k, k_new, at)
        _write_token(cache_v, v_new, at)
        qg = q.reshape(b, hkv, h // hkv, hd).float()
        logits = masked_decode_logits(qg, cache_k.float(), hd ** -0.5, bias,
                                      lengths)
        pr = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgs,bhsd->bhgd", pr,
                           cache_v.float()).reshape(b, h, hd)
    out = out.reshape(b, h * hd).to(x_t.dtype)
    return out @ p.wo, (cache_k, cache_s_k, cache_v, cache_s_v)
