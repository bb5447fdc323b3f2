"""int8 KV quantization and the plain decode-attention versions
(counterpart of ``repro.kernels.kvq.ref``).

* :func:`decode_attention_ref` -- one exact softmax over the whole cache,
  ``lengths`` masked by a position compare (never a (B, S) bias tensor).
* :func:`decode_attention_splitk_ref` -- per-split masked-softmax partials
  merged by :func:`combine_splits`, the plain twin of the kernel's split-K
  arithmetic.
* :func:`decode_partials_ref` -- the unnormalised (o, m, l) of one shard of
  the cache, which a sequence-sharded decode merges across devices
  (``distributed/collectives.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import tiling
from repro_torch.kernels.tiling import NEG_INF


def quantize_kv(x: torch.Tensor):
    """(..., S, D) float -> (int8 values, f32 scales (..., S)).

    scale = amax / 127 (1.0 for an all-zero row); ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(xf / scale[..., None])
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def masked_decode_logits(q, k, sm_scale, bias, lengths):
    """(B, Hkv, G, S) masked decode logits; ``lengths`` masks by a position
    compare, ``bias`` (B, S) is added (exclusive)."""
    logits = torch.einsum("bhgd,bhsd->bhgs", q.float(), k) * sm_scale
    if lengths is not None:
        kpos = torch.arange(logits.shape[-1], device=logits.device)
        ok = kpos[None, :] < lengths[:, None]                   # (B, S)
        logits = torch.where(ok[:, None, None, :], logits,
                             torch.full_like(logits, NEG_INF))
    elif bias is not None:
        logits = logits + bias[:, None, None, :]
    return logits


def decode_attention_ref(q, k_q, k_s, v_q, v_s, bias, sm_scale: float,
                         lengths=None):
    """q (B, Hkv, G, D) f32; k_q, v_q (B, Hkv, S, D) int8; k_s, v_s
    (B, Hkv, S) f32; bias (B, S) or None; lengths (B,) or None
    -> (B, Hkv, G, D) f32."""
    if bias is not None and lengths is not None:
        raise ValueError("decode_attention_ref: bias and lengths are "
                         "exclusive")
    k = dequantize_kv(k_q, k_s)
    v = dequantize_kv(v_q, v_s)
    logits = masked_decode_logits(q, k, sm_scale, bias, lengths)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgs,bhsd->bhgd", p, v)


def merge_splits(o_p, m_p, l_p):
    """The splits of one call merged WITHOUT dividing by l: (acc (B, Hkv,
    G, D), m (B, Hkv, G), l (B, Hkv, G)) in natural-log units.

    o_p (B, Hkv, splits, G, D) unnormalised accumulators; m_p, l_p
    (B, Hkv, splits, G).  Dead splits carry (0, NEG_INF, 0) and drop out
    (their weight underflows to 0 against any live max); when every split
    is dead the result is (0, NEG_INF, 0)."""
    m_max = m_p.amax(dim=2)                                    # (B, Hkv, G)
    alpha = torch.exp(m_p - m_max[:, :, None])
    l_tot = (l_p * alpha).sum(dim=2)
    acc = (o_p * alpha[..., None]).sum(dim=2)
    return acc, m_max, l_tot


def combine_splits(o_p, m_p, l_p, dtype):
    """Online-softmax merge of split-K partials (:func:`merge_splits`),
    normalised."""
    acc, _, l_tot = merge_splits(o_p, m_p, l_p)
    return (acc / torch.clamp(l_tot, min=1e-30)[..., None]).to(dtype)


def decode_partials_ref(q, k_q, k_s, v_q, v_s, bias, sm_scale: float,
                        lengths=None):
    """The unnormalised softmax partials of one cache shard: q (B, Hkv, G,
    D) f32 against k_q, v_q (B, Hkv, S, D) int8 with (B, Hkv, S) f32
    scales, masked by ``lengths`` (B,) or ``bias`` (B, S) -> (o (B, Hkv, G,
    D), m (B, Hkv, G), l (B, Hkv, G)) f32, natural-log units.  A row with
    no live position here gives (0, NEG_INF, 0) (the reference's
    ``collectives.py:158-162``)."""
    if bias is not None and lengths is not None:
        raise ValueError("decode_partials_ref: bias and lengths are "
                         "exclusive")
    logits = masked_decode_logits(q, dequantize_kv(k_q, k_s), sm_scale,
                                  bias, lengths)
    ok = logits > NEG_INF / 2
    m = torch.where(ok.any(-1), logits.amax(-1),
                    torch.full(logits.shape[:-1], NEG_INF,
                               device=logits.device))
    p = torch.where(ok, torch.exp(logits - m[..., None]),
                    torch.zeros_like(logits))
    o = torch.einsum("bhgs,bhsd->bhgd", p, dequantize_kv(v_q, v_s))
    return o, m, p.sum(-1)


def decode_attention_splitk_ref(q, k_q, k_s, v_q, v_s, sm_scale: float, *,
                                lengths=None, bias=None,
                                block_s: int = tiling.DEFAULT_DECODE_BS,
                                splits: int = 1):
    """Split-K plain version: per-shard partials over the kernel's shard
    boundaries (``tiling.resolve_decode_grid``) and :func:`combine_splits`."""
    if bias is not None and lengths is not None:
        raise ValueError("decode_attention_splitk_ref: bias and lengths "
                         "are exclusive")
    s = k_q.shape[2]
    bs, ns, n_sp, spt = tiling.resolve_decode_grid(s, block_s=block_s,
                                                   splits=splits)
    v = dequantize_kv(v_q, v_s)
    logits = masked_decode_logits(q, dequantize_kv(k_q, k_s), sm_scale,
                                  bias, lengths)                # (B,Hkv,G,S)
    valid = logits > NEG_INF / 2
    m_p, l_p, o_p = [], [], []
    for sp in range(n_sp):
        lo, hi = sp * spt * bs, min((sp + 1) * spt, ns) * bs
        if lo >= hi:
            # empty final shard: the kernel leaves its init state
            m_p.append(torch.full(logits.shape[:-1], NEG_INF,
                                  device=q.device))
            l_p.append(torch.zeros(logits.shape[:-1], device=q.device))
            o_p.append(torch.zeros(q.shape, device=q.device))
            continue
        lg, ok = logits[..., lo:hi], valid[..., lo:hi]
        m = torch.where(ok.any(-1), lg.amax(-1),
                        torch.full(lg.shape[:-1], NEG_INF, device=q.device))
        p = torch.where(ok, torch.exp(lg - m[..., None]),
                        torch.zeros_like(lg))
        m_p.append(m)
        l_p.append(p.sum(-1))
        o_p.append(torch.einsum("bhgs,bhsd->bhgd", p, v[:, :, lo:hi]))
    return combine_splits(torch.stack(o_p, 2), torch.stack(m_p, 2),
                          torch.stack(l_p, 2), q.dtype)
