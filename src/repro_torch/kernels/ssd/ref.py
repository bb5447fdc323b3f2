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
computes), ``ssd_chunk_bwd_ref`` its gradient by the explicit formulas
(what ``kernels/csrc/ssd_bwd.cu`` computes); ``ssd_scan_ref`` is the full
O(L) recurrence.
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


def ssd_chunk_bwd_ref(c, b, xbar, acum, dy, dstate):
    """The gradient of :func:`ssd_chunk_ref` by its explicit formulas.

    c, b: (G // H, T, Q, N), shared by the H heads of a folded batch row
    (row g reads c[g // H]); xbar, dy: (G, T, Q, P); acum: (G, T, Q);
    dstate: (G, T, N, P).  With S = C B^T, L = exp(acum_i - acum_j) on and
    below the diagonal (0 above), M = S o L and w = exp(acum_Q - acum):
      dM = (dy xbar^T) o mask,  dS = dM o L,  U = B dstate
      dxbar = M^T dy + w o U;  dc = dS B;  db = dS^T C + w o (xbar dstate^T)
      dacum_i = rowsum(dM o M)_i - colsum(dM o M)_i - w_i (xbar_i . U_i)
                + [i = Q-1] sum_j w_j (xbar_j . U_j)
    Returns (dc, db) summed over the heads that share them, as (G // H, T,
    Q, N), then dxbar, dacum."""
    g, t, q, p = xbar.shape
    heads = g // c.shape[0]
    ce = c.repeat_interleave(heads, dim=0)
    be = b.repeat_interleave(heads, dim=0)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=c.device))
    # exp of the masked log-decay only: above the diagonal it would overflow
    ldecay = torch.exp(torch.where(mask, acum[..., :, None]
                                   - acum[..., None, :], -torch.inf))
    m = torch.einsum("gtqn,gtsn->gtqs", ce, be) * ldecay
    dm = torch.einsum("gtqp,gtsp->gtqs", dy, xbar) * mask
    ds = dm * ldecay
    w = torch.exp(acum[..., -1:] - acum)                           # (G,T,Q)
    u = torch.einsum("gtqn,gtnp->gtqp", be, dstate)
    dx = torch.einsum("gtqs,gtqp->gtsp", m, dy) + w[..., None] * u
    dc = torch.einsum("gtqs,gtsn->gtqn", ds, be)
    db = torch.einsum("gtqs,gtqn->gtsn", ds, ce) + w[..., None] * torch.einsum(
        "gtqp,gtnp->gtqn", xbar, dstate)
    z = dm * m
    wu = w * (xbar * u).sum(-1)
    da = z.sum(-1) - z.sum(-2) - wu
    da[..., -1] += wu.sum(-1)
    fold = lambda v: v.reshape(g // heads, heads, *v.shape[1:]).sum(1)  # noqa
    return fold(dc), fold(db), dx, da


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
