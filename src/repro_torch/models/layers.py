"""Shared building blocks: RMSNorm, mamba2's gated RMSNorm, SwiGLU,
whisper's GELU MLP, rotary embeddings (standard, fractional and qwen2-vl's
M-RoPE), initializers (counterpart of ``repro.models.layers``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _rms_norm_value(x, w, eps):
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * w.to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5, *,
             bf16_grad: bool = False):
    """RMSNorm with f32 internals: normalise in f32, cast to ``x.dtype``,
    then scale by ``w`` in that dtype (the order of ``layers.py:21``).

    ``bf16_grad`` differentiates through :class:`_RmsNormLowGrad`, whose
    input cotangent leaves in ``x.dtype`` (bf16 under mixed precision)
    instead of f32; forward values are identical."""
    if bf16_grad:
        return _RmsNormLowGrad.apply(x, w, eps)
    return _rms_norm_value(x, w, eps)


class _RmsNormLowGrad(torch.autograd.Function):
    """The custom-VJP RMSNorm of the JAX package (``layers.py:28-57``):
    the backward recomputes x-hat in f32 and returns dx in ``x.dtype``,
    dw in ``w.dtype``."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rms_norm_value(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xf, gf, wf = x.float(), g.float(), w.float()
        inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + ctx.eps)
        xhat = xf * inv
        dw = (gf * xhat).sum(dim=tuple(range(x.ndim - 1)))
        gw = gf * wf
        dx = inv * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
        return dx.to(x.dtype), dw.to(w.dtype), None


def gated_rms_norm(x, z, w, eps: float = 1e-5):
    """Mamba2 output norm: RMSNorm(x * silu(z)), silu taken in f32 and cast
    to ``x.dtype`` before the product."""
    return rms_norm(x * F.silu(z.float()).to(x.dtype), w, eps)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w1, b1, w2, b2):
    """The two-layer MLP with biases and the tanh-approximated GELU (the
    reference's ``jax.nn.gelu(approximate=True)``); ``b2`` None leaves
    the output bias to the caller (a row-parallel ``w2`` adds it after
    its sum)."""
    out = F.gelu(x @ w1 + b1, approximate="tanh") @ w2
    return out if b2 is None else out + b2


def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0,
               device=None):
    """Inverse frequencies for the rotated sub-dimension."""
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0, mrope_sections=None):
    """x: (..., S, H, D); positions: (..., S) int, or (3, ..., S) for
    M-RoPE: the temporal, height and width streams, and rotary frequency
    ``f`` turns by the stream its section names (the first
    ``mrope_sections[0]`` frequencies by stream 0, and so on)."""
    d = x.shape[-1]
    inv, rot = rope_freqs(d, theta, fraction, device=x.device)
    if mrope_sections is not None:
        assert sum(mrope_sections) == rot // 2, (mrope_sections, rot)
        stream = torch.tensor([i for i, n in enumerate(mrope_sections)
                               for _ in range(n)], device=x.device)  # (rot/2,)
        # (..., S, 3) -> each frequency's stream: the reference's one-hot
        # einsum, exactly (a product by 1.0 and sums of zeros)
        ang = positions.float().movedim(0, -1)[..., stream] * inv
    else:
        ang = positions.float()[..., None] * inv        # (..., S, rot/2)
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
