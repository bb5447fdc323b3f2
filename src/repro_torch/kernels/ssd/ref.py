"""Plain PyTorch versions of the SSD (state-space duality) chunk kernel
(counterpart of ``repro.kernels.ssd.ref``).

Mamba-2 SSD semantics, per head: with per-step log-decay a_t = dt_t * A and
inclusive cumsum Acum, the sequence output is

  h_t = exp(a_t) h_{t-1} + B_t xbar_t ;   y_t = C_t^T h_t + D x_t

The chunked form splits L into chunks of Q and computes, per chunk,
  intra  : y_t += sum_{s<=t} (C_t.B_s) exp(Acum_t - Acum_s) xbar_s
  state  : S'   = exp(Acum_Q) S + sum_s exp(Acum_Q - Acum_s) B_s^T xbar_s
  inter  : y_t += exp(Acum_t) (C_t @ S)

``ssd_chunk_ref`` covers the intra + state terms (what the CUDA kernel
computes); ``ssd_scan_ref`` is the full O(L) recurrence.
"""
from __future__ import annotations

import torch


def ssd_chunk_ref(c, b, xbar, acum):
    """c, b: (G, T, Q, N); xbar: (G, T, Q, P); acum: (G, T, Q) inclusive
    cumsum.  Returns (y_intra (G, T, Q, P), chunk_state (G, T, N, P)).
    G folds batch * heads; T is the number of chunks."""
    q = c.shape[-2]
    scores = torch.einsum("gtqn,gtsn->gtqs", c, b)
    decay = torch.exp(acum[..., :, None] - acum[..., None, :])     # (G,T,Q,Q)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=c.device))
    g = torch.where(mask, scores * decay, torch.zeros((), device=c.device))
    y_intra = torch.einsum("gtqs,gtsp->gtqp", g, xbar)
    w = torch.exp(acum[..., -1:] - acum)                           # (G,T,Q)
    state = torch.einsum("gtqn,gtqp->gtnp", b * w[..., None], xbar)
    return y_intra, state


def ssd_scan_ref(x, dt, a, b, c, d):
    """The exact sequential recurrence.  x: (B, L, H, P); dt: (B, L, H);
    a: (H,) (negative); b, c: (B, L, N); d: (H,).  Returns y (B, L, H, P)."""
    bsz, L, h, p = x.shape
    n = b.shape[-1]
    da = torch.exp(dt * a[None, None, :])                          # (B, L, H)
    xbar = x * dt[..., None]
    s = torch.zeros((bsz, h, n, p), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(L):
        s = s * da[:, t, :, None, None] + torch.einsum(
            "bn,bhp->bhnp", b[:, t], xbar[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", c[:, t], s))
    y = torch.stack(ys, 1)
    return y + x * d[None, None, :, None]
