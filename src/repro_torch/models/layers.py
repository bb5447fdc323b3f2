"""Shared building blocks: RMSNorm, SwiGLU, rotary embeddings, initializers
(counterpart of ``repro.models.layers``).  M-RoPE waits for qwen2-vl."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """RMSNorm with f32 internals: normalise in f32, cast to ``x.dtype``,
    then scale by ``w`` in that dtype (the order of ``layers.py:21``)."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * w.to(dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0,
               device=None):
    """Inverse frequencies for the rotated sub-dimension."""
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0):
    """x: (..., S, H, D); positions: (..., S) int."""
    d = x.shape[-1]
    inv, rot = rope_freqs(d, theta, fraction, device=x.device)
    ang = positions.float()[..., None] * inv            # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)      # broadcast over heads
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., : rot // 2], x[..., rot // 2: rot]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rot < d:
        out = torch.cat([out, x[..., rot:]], dim=-1)
    return out


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, device=None):
    fan_in = shape[in_axis]
    scale = (1.0 / max(1, fan_in)) ** 0.5
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device) * scale


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device=None):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * 0.02
