"""Public flash-attention op (counterpart of ``repro.kernels.flash.ops``).

The op dispatches on the device of its tensors: CPU tensors go to the
plain version in ``ref.py``; CUDA tensors go to the hand-written kernel
``kernels/csrc/flash_fwd.cu`` or raise.  Nothing falls back from one to
the other.  The TPU path's 128-lane padding and its shape fallback do
not carry over: the kernel masks the ragged tail itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, tiling
from repro_torch.kernels.flash import ref

BQ = BK = 64                       # the kernel's q and KV tile sizes
SUPPORTED_HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = build.Kernel("flash_fwd", "flash_fwd", [
    build.PTR, build.PTR, build.PTR, build.PTR, build.PTR, build.PTR,
    build.PTR, build.INT, build.INT, build.INT, build.INT, build.INT,
    build.INT, build.INT, build.INT, build.FLOAT, build.PTR])


def expected_counts(s: int, *, causal: bool = True, window: int = 0,
                    kv_len: int | None = None) -> list[int]:
    """Per-q-tile KV steps the kernel executes for a length-S row: the
    analytic twin from ``tiling.kv_visits`` on the 64-padded length."""
    n_q = -(-s // BQ)
    return tiling.kv_visits(n_q * BQ, bq=BQ, bk=BK, causal=causal,
                            window=window, kv_len=s if kv_len is None
                            else kv_len)


def _check_cuda(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_fwd: q, k, v must all be on the "
                         "same device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: the CUDA kernel takes f32 or "
                        f"bf16 q, k, v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    d = q.shape[-1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS} for the CUDA kernel")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k, v must be contiguous")


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        sm_scale: float | None = None,
                        kv_len: int | None = None, counts: bool = False):
    """Flat layout: q (BH, S, D); k, v (BHkv, S, D) with BH = BHkv * group.

    Returns (o, m, l): o (BH, S, D) in q's dtype and the f32 row stats
    (BH, S) the backward will read.  With ``counts`` (CUDA only) also a
    (BH, n_q) int32 tensor of KV tiles executed per 64-row q tile, to be
    held against :func:`expected_counts`."""
    bh, s, d = q.shape
    bhkv = k.shape[0]
    if k.shape != (bhkv, s, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: k{tuple(k.shape)}, "
                         f"v{tuple(v.shape)} do not match q{tuple(q.shape)}")
    if bhkv == 0 or bh % bhkv:
        raise ValueError(f"flash_attention_fwd: {bh} query rows are not a "
                         f"multiple of {bhkv} KV rows (GQA)")
    kv_len = s if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= s:
        raise ValueError(f"flash_attention_fwd: kv_len {kv_len} outside "
                         f"[0, {s}]")
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    if not q.is_cuda:
        if counts:
            raise ValueError("flash_attention_fwd: counts come from the CUDA "
                             "kernel; the plain version runs no tiles")
        return ref.flash_fwd_ref(q, k, v, causal=causal, window=window,
                                 sm_scale=scale, kv_len=kv_len)
    _check_cuda(q, k, v)
    o = torch.empty_like(q)
    m = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    l = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    cnt = (torch.empty((bh, -(-s // BQ)), dtype=torch.int32, device=q.device)
           if counts else None)
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           m.data_ptr(), l.data_ptr(),
           None if cnt is None else cnt.data_ptr(), bh, bhkv, s, d,
           _DTYPES[q.dtype], int(bool(causal)), int(window), kv_len, scale,
           torch.cuda.current_stream(q.device).cuda_stream)
    return (o, m, l, cnt) if counts else (o, m, l)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    sm_scale: float | None = None):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D) -> (B, H, S, D)."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if hkv == 0 or h % hkv:
        raise ValueError(
            f"flash_attention: n_heads={h} must be a non-zero multiple of "
            f"n_kv={hkv} (GQA) for q{tuple(q.shape)}, k{tuple(k.shape)}")
    # reshape of a (B, S, H, D) transpose is a strided view when B == 1
    o, _, _ = flash_attention_fwd(
        q.reshape(b * h, s, d).contiguous(),
        k.reshape(b * hkv, s, d).contiguous(),
        v.reshape(b * hkv, s, d).contiguous(), causal=causal, window=window,
        sm_scale=sm_scale)
    return o.reshape(b, h, s, d)
