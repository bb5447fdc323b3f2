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
    ok = _mask(s, kv_len, causal, window, q.device)
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


def _mask(s: int, kv_len: int, causal: bool, window: int, device):
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    ok = kpos < kv_len
    if causal:
        ok = ok & (qpos >= kpos)
        if window > 0:
            ok = ok & ((qpos - kpos) < window)
    return ok


def bwd_delta_ref(o, do):
    """D = rowsum(dO o O) in f32: (BH, S, D) x 2 -> (BH, S)."""
    return (o.float() * do.float()).sum(-1)


def _probs_and_ds(q, k, v, do, m, l, delta, causal, window, scale, kv_len):
    """Recompute P from the saved stats and form dS, both (BHkv, G, S, S)
    f32, exactly as the TPU kernels' ``_recompute_probs`` does: P =
    exp(S - (m + log max(l, 1e-30))), masked entries exactly 0."""
    bh, s, d = q.shape
    bhkv = k.shape[0]
    g = bh // bhkv
    qg = q.float().reshape(bhkv, g, s, d)
    dog = do.float().reshape(bhkv, g, s, d)
    lse = (m + torch.log(torch.clamp(l, min=1e-30))).reshape(bhkv, g, s)
    scores = torch.einsum("hgqd,hkd->hgqk", qg, k.float()) * scale
    ok = _mask(s, kv_len, causal, window, q.device)
    p = torch.where(ok, torch.exp(scores - lse[..., None]),
                    torch.zeros_like(scores))
    dp = torch.einsum("hgqd,hkd->hgqk", dog, v.float())
    ds = p * (dp - delta.reshape(bhkv, g, s)[..., None])
    return qg, dog, p, ds


def bwd_dq_ref(q, k, v, do, m, l, delta, *, causal: bool = True,
               window: int = 0, sm_scale: float, kv_len: int, dtype):
    """dQ = dS K scale, (BH, S, D) in ``dtype``."""
    _, _, _, ds = _probs_and_ds(q, k, v, do, m, l, delta, causal, window,
                                sm_scale, kv_len)
    dq = torch.einsum("hgqk,hkd->hgqd", ds, k.float()) * sm_scale
    return dq.reshape(q.shape).to(dtype)


def bwd_dkv_ref(q, k, v, do, m, l, delta, *, causal: bool = True,
                window: int = 0, sm_scale: float, kv_len: int, dk_dtype,
                dv_dtype):
    """dK = dS^T Q scale and dV = P^T dO, summed over the GQA group,
    (BHkv, S, D) each."""
    qg, dog, p, ds = _probs_and_ds(q, k, v, do, m, l, delta, causal, window,
                                   sm_scale, kv_len)
    dk = torch.einsum("hgqk,hgqd->hkd", ds, qg) * sm_scale
    dv = torch.einsum("hgqk,hgqd->hkd", p, dog)
    return dk.to(dk_dtype), dv.to(dv_dtype)


def flash_bwd_ref(q, k, v, o, m, l, do, *, causal: bool = True,
                  window: int = 0, sm_scale: float | None = None,
                  kv_len: int | None = None, grad_dtypes=None):
    """Plain f32 backward from the forward's residuals -> (dq, dk, dv): the
    three steps of the CUDA kernels, each as its own plain function.

    q, o, do: (BH, S, D); k, v: (BHkv, S, D); m, l: (BH, S) f32.
    Gradients come out in ``grad_dtypes`` (dq, dk, dv; default: the
    dtypes of q, k, v)."""
    d = q.shape[-1]
    kw = dict(causal=causal, window=window,
              sm_scale=sm_scale if sm_scale is not None else d ** -0.5,
              kv_len=q.shape[1] if kv_len is None else kv_len)
    dq_dt, dk_dt, dv_dt = (q.dtype, k.dtype, v.dtype) if grad_dtypes is \
        None else grad_dtypes
    delta = bwd_delta_ref(o, do)
    dq = bwd_dq_ref(q, k, v, do, m, l, delta, dtype=dq_dt, **kw)
    dk, dv = bwd_dkv_ref(q, k, v, do, m, l, delta, dk_dtype=dk_dt,
                         dv_dtype=dv_dt, **kw)
    return dq, dk, dv
