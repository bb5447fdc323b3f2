"""Mamba-2 (SSD) sequence mixer (counterpart of ``repro.models.ssm``): the
full-sequence path through the chunked SSD op (``kernels/ssd``: the CUDA
chunk kernel on the card, its plain version on the CPU), and the O(1)-state
single-token decode.

``p`` is a block's ``SSM`` module (``models/transformer.py``): in_proj,
conv_w, dt_bias, a_log, d_skip, norm_w, out_proj, in the JAX layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import gated_rms_norm


def _split_in_proj(cfg, proj):
    """in_proj output -> (z, x, B, C, dt) along the last axis."""
    s = cfg.ssm
    return torch.split(proj, [s.d_inner, s.d_inner, s.d_state, s.d_state,
                              s.heads], dim=-1)


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv1d.  x: (B, S, C); w: (K, C).

    With ``cache`` (B, K-1, C) the last K-1 inputs are prepended (decode);
    returns (silu(y), new_cache (B, K-1, C) in ``x.dtype``)."""
    k = w.shape[0]
    if cache is None:
        ctx = F.pad(x, (0, 0, k - 1, 0))
    else:
        ctx = torch.cat([cache.to(x.dtype), x], dim=1)
    n = x.shape[1]
    y = sum(ctx[:, i:i + n] * w[i][None, None] for i in range(k))
    new_cache = ctx[:, -(k - 1):] if k > 1 else None
    return F.silu(y), new_cache


def ssm_block(p, x, cfg, *, return_state: bool = False):
    """x: (B, S, D) -> (B, S, D) [, {'conv': (B, K-1, C), 'ssm': (B, H, N,
    P)}].  Weights are cast to ``x.dtype`` where they are used, as the JAX
    forward casts its tree to the compute dtype."""
    s = cfg.ssm
    b, L, _ = x.shape
    dt_ = x.dtype
    proj = x @ p.in_proj.to(dt_)
    z, xc, bm, cm, dt = _split_in_proj(cfg, proj)
    conv_in = torch.cat([xc, bm, cm], dim=-1)
    conv_out, _ = _causal_conv(conv_in, p.conv_w.to(dt_))
    conv_tail = conv_in[:, -(s.conv_kernel - 1):]            # decode cache
    xc, bm, cm = torch.split(conv_out, [s.d_inner, s.d_state, s.d_state],
                             dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias.to(dt_))
    a = -torch.exp(p.a_log.to(dt_).float())
    y = ssd_ops.ssd(xc.reshape(b, L, s.heads, s.head_p), dt, a, bm, cm,
                    p.d_skip.to(dt_), chunk=min(s.chunk, L),
                    return_state=return_state)
    if return_state:
        y, final_state = y
    y = gated_rms_norm(y.reshape(b, L, s.d_inner), z, p.norm_w.to(dt_),
                       cfg.norm_eps)
    out = y @ p.out_proj.to(dt_)
    if return_state:
        return out, {"conv": conv_tail, "ssm": final_state}
    return out, None


def ssm_decode_step(p, x_t, cfg, conv_cache, ssm_state):
    """x_t: (B, D); conv_cache: (B, K-1, conv_dim); ssm_state: (B, H, N, P).
    Returns (out (B, D), new conv cache in ``conv_cache.dtype``, new state
    in ``ssm_state.dtype``)."""
    s = cfg.ssm
    b = x_t.shape[0]
    proj = x_t @ p.in_proj
    z, xc, bm, cm, dt = _split_in_proj(cfg, proj)
    conv_in = torch.cat([xc, bm, cm], dim=-1)[:, None]            # (B, 1, C)
    conv_out, new_conv = _causal_conv(conv_in, p.conv_w, cache=conv_cache)
    xc, bm, cm = torch.split(conv_out[:, 0], [s.d_inner, s.d_state,
                                              s.d_state], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)
    a = -torch.exp(p.a_log.float())
    new_state, y = ssd_ops.ssd_decode_step(
        ssm_state.float(), xc.reshape(b, s.heads, s.head_p).float(), dt, a,
        bm.float(), cm.float(), p.d_skip)
    y = y.reshape(b, s.d_inner).to(x_t.dtype)
    y = gated_rms_norm(y, z, p.norm_w, cfg.norm_eps)
    return (y @ p.out_proj, new_conv.to(conv_cache.dtype),
            new_state.to(ssm_state.dtype))
