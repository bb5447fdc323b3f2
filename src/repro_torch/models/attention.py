"""GQA attention for prefill and cached decode (counterpart of
``repro.models.attention``, dense branch).

Prefill and training always go through the flash op (``kernels/flash``):
the CUDA kernels on the card, their plain versions on the CPU; it is
differentiable, so ``loss.backward()`` runs the flash backward.  Decode writes the new
token into the cache in place and reads the cache through
``kernels/kvq.decode_attention`` (quantized) or the plain masked softmax
(unquantized).  The window/bias decode path, MLA, cross-attention and the
sequence-sharded cache come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.kvq import ops as kvq_ops
from repro_torch.kernels.kvq.ref import masked_decode_logits
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


def attn_decode(p, x_t, cfg, cache_k, cache_s_k, cache_v, cache_s_v, pos,
                *, quantized: bool = True, splits: int = 1):
    """One-token GQA decode against a per-layer cache.

    x_t: (B, D_model); cache_k/v (B, Hkv, S, hd) int8 (or the compute dtype
    when not quantized, scales unused); pos: 0-d int32 position, or (B,)
    int32 per-row positions (slot-pooled serving: each row rotates, writes
    and masks at its own position).  Masking is by length, ``pos + 1``.
    The cache leaves are updated in place and returned.
    Returns (attn_out (B, D_model), (k, k_scale, v, v_scale))."""
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
    lengths = (pos + 1).to(torch.int32).expand(b).contiguous()

    if quantized:
        kq_new, ks_new = kvq_ops.quantize_kv(k_new)
        vq_new, vs_new = kvq_ops.quantize_kv(v_new)
        _write_token(cache_k, kq_new, pos)
        _write_token(cache_v, vq_new, pos)
        _write_token(cache_s_k, ks_new, pos)
        _write_token(cache_s_v, vs_new, pos)
        out = kvq_ops.decode_attention(q, cache_k, cache_s_k, cache_v,
                                       cache_s_v, lengths=lengths,
                                       splits=splits)
    else:
        _write_token(cache_k, k_new, pos)
        _write_token(cache_v, v_new, pos)
        qg = q.reshape(b, hkv, h // hkv, hd).float()
        logits = masked_decode_logits(qg, cache_k.float(), hd ** -0.5, None,
                                      lengths)
        pr = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgs,bhsd->bhgd", pr,
                           cache_v.float()).reshape(b, h, hd)
    out = out.reshape(b, h * hd).to(x_t.dtype)
    return out @ p.wo, (cache_k, cache_s_k, cache_v, cache_s_v)
