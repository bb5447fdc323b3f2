"""Plain PyTorch version of the flash-attention forward: exact GQA softmax
in f32 (counterpart of ``repro.kernels.flash.ref``).  The wrapper in
``ops.py`` uses it for CPU tensors; ``chip_smoke.py`` holds the CUDA
kernel against it on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  sm_scale: float | None = None, kv_len: int | None = None):
    """q: (BH, S, D); k, v: (BHkv, S, D) -> (o, m, l).

    ``o`` (BH, S, D) in q's dtype; ``m``, ``l`` (BH, S) f32 are the row max
    of the masked scaled scores and the softmax denominator
    sum(exp(s - m)) -- what the kernel's online softmax ends with.
    Keys at or past ``kv_len`` are masked, as ``_position_mask`` does."""
    bh, s, d = q.shape
    bhkv = k.shape[0]
    g = bh // bhkv
    scale = sm_scale if sm_scale is not None else d ** -0.5
    kv_len = s if kv_len is None else kv_len
    qg = q.float().reshape(bhkv, g, s, d)
    logits = torch.einsum("hgqd,hkd->hgqk", qg, k.float()) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    ok = kpos < kv_len
    if causal:
        ok = ok & (qpos >= kpos)
        if window > 0:
            ok = ok & ((qpos - kpos) < window)
    logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("hgqk,hkd->hgqd", p, v.float()) / \
        torch.clamp(l, min=1e-30)[..., None]
    return (o.reshape(bh, s, d).to(q.dtype), m.reshape(bh, s),
            l.reshape(bh, s))


def flash_ref(q, k, v, *, causal: bool = True, window: int = 0,
              sm_scale: float | None = None):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D) -> (B, H, S, D)."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    o, _, _ = flash_fwd_ref(q.reshape(b * h, s, d), k.reshape(b * hkv, s, d),
                            v.reshape(b * hkv, s, d), causal=causal,
                            window=window, sm_scale=sm_scale)
    return o.reshape(b, h, s, d)
