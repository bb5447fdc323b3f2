"""The tensor-core backward of the SSD chunk (``kernels/csrc/ssd_bwd_sm90.cu``)
on the CPU: which kernel a CUDA chunk's gradient goes to
(``ops.ssd_bwd_route``), the head-sum identity the kernel rests on, and
whether its rounding points fit the tolerance the card holds it to.

The CUDA kernel runs only on the card (``tests/test_torch_ssd_bwd.py``'s
``cuda`` tests).  Here an emulation of its arithmetic, written with numpy,
is held against ``ref.ssd_chunk_bwd_ref`` and against ``jax.vjp`` of the
JAX package's ``ssd_chunk_ref``, at 1e-4 of each output's largest value
(the tolerance of the card tests and ``chip_smoke.py``; dacum against its
own largest value).  The emulation follows the kernel:

* every operand of a product is split x = hi + lo, hi = tf32(x), lo =
  tf32(x - hi) (round to nearest on the 10-bit mantissa, ties away from
  zero, as ``sm90.cuh`` ``tf32_rna``); a product is three tf32 passes,
  hi lo + lo hi + hi hi, summed in f32;
* S = C B^T once per (batch, chunk), shared by the heads;
* per head: U = B dstate; E += (w o xbar) dstate^T (summed over the heads
  in head order); v_j = w_j sum_p (xhi + xlo)_jp U_jp; dxbar = w o U +
  M^T dy, with M = S o exp2((a_i - a_j) log2 e) on and below the diagonal
  and a select (exactly 0) above it; dM = dy xbar^T; dS = dM o L; D +=
  dS (head order); Z = dS o S, its row and column sums;
* after the heads: db = E + D^T C and dc = D B, once;
* dacum_i = rowsum(Z)_i - colsum(Z)_i - v_i + [i = Q-1] sum_j v_j;
* rows past Q are zero in every operand, a is padded with a[Q-1].
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ref as jref
from repro_torch.kernels.ssd import ops, ref

TOL = 1e-4
F32 = np.float32
LOG2E = F32(1.4426950408889634)
QMAX = 128
NAMES = ("dc", "db", "dxbar", "dacum")


@pytest.mark.parametrize("n,p,route", [(128, 64, "sm90"), (16, 64, "sm90"),
                                       (128, 16, "fma"), (16, 16, "fma")])
def test_ssd_bwd_route(n, p, route):
    assert ops.ssd_bwd_route(n, p) == route


@pytest.mark.parametrize("n,p", [(32, 64), (64, 64), (128, 32), (16, 128)])
def test_ssd_bwd_route_raises_for_what_no_kernel_takes(n, p):
    with pytest.raises(ValueError, match="d_state"):
        ops.ssd_bwd_route(n, p)


def tf32(x):
    """Round f32 to tf32 (10 mantissa bits), nearest, ties away from zero."""
    bits = np.asarray(x, F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(x):
    x = np.asarray(x, F32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def product3(a, b, passes=3):
    """a @ b (batched) as the kernel's tf32 passes, summed in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    terms = [(ah, bl), (al, bh), (ah, bh)][3 - passes:]
    acc = None
    for x, y in terms:
        prod = np.matmul(x, y, dtype=F32)    # tf32 x tf32 is exact in f32
        acc = prod if acc is None else (acc + prod).astype(F32)
    return acc


def exp2_f32(z):
    return np.exp2(np.asarray(z, F32).astype(np.float64)).astype(F32)


def _pad(z, axis):
    """Zero rows past Q up to the kernel's 128 along ``axis``."""
    widths = [(0, 0)] * z.ndim
    widths[axis] = (0, QMAX - z.shape[axis])
    return np.pad(z, widths)


def emulate(c, b, x, acum, dy, dst, passes=3):
    """The sm90 backward's arithmetic: c, b (G/H, T, Q, N); x, dy (G, T,
    Q, P); acum (G, T, Q); dst (G, T, N, P) -> (dc, db, dxbar, dacum)."""
    gh, t, q, n = c.shape
    g = x.shape[0]
    heads = g // gh
    cp, bp = _pad(c, 2), _pad(b, 2)
    xp, dyp = _pad(x, 2), _pad(dy, 2)
    ap = np.concatenate([acum, np.repeat(acum[..., -1:], QMAX - q, -1)], -1)
    live = np.tril(np.ones((QMAX, QMAX), bool))
    rows = np.arange(QMAX) < q
    s = product3(cp, np.swapaxes(bp, -1, -2), passes)   # once per (b, t)
    s = np.where(live, s, F32(0))                        # blocks kept
    e = np.zeros((gh, t, QMAX, n), F32)
    d = np.zeros((gh, t, QMAX, QMAX), F32)
    dx = np.zeros((g, t, q, x.shape[-1]), F32)
    da = np.zeros((g, t, q), F32)
    for hh in range(heads):
        sl = slice(hh, g, heads)                         # rows g = bt H + h
        a = ap[sl]
        w = exp2_f32((a[..., -1:] - a) * LOG2E)          # (GH, T, 128)
        ldec = np.where(live, exp2_f32((a[..., :, None] - a[..., None, :])
                                       * LOG2E), F32(0))
        u = product3(bp, dst[sl], passes)
        e = (e + product3(xp[sl] * w[..., None], np.swapaxes(dst[sl], -1, -2),
                          passes)).astype(F32)
        xh, xl = split(xp[sl])
        v = np.where(rows, w * ((xh + xl) * u).sum(-1, dtype=F32), F32(0))
        m = (s * ldec).astype(F32)
        dxh = (w[..., None] * u + product3(np.swapaxes(m, -1, -2), dyp[sl],
                                           passes)).astype(F32)
        dm = product3(dyp[sl], np.swapaxes(xp[sl], -1, -2), passes)
        ds = (dm * ldec).astype(F32)
        d = (d + ds).astype(F32)
        z = (ds * s).astype(F32)
        dah = (z.sum(-1, dtype=F32) - z.sum(-2, dtype=F32) - v).astype(F32)
        dah[..., q - 1] += v.sum(-1, dtype=F32)
        dx[sl] = dxh[..., :q, :]
        da[sl] = dah[..., :q]
    db = (e + product3(np.swapaxes(d, -1, -2), cp, passes)).astype(F32)
    dc = product3(d, bp, passes)
    return dc[..., :q, :], db[..., :q, :], dx, da


def _inputs(gh, heads, t, q, n, seed):
    """check_ssd_bwd's distribution: normal c, b, xbar, dy, dstate; steps
    of -U(0, 0.2)."""
    rng = np.random.default_rng(seed)
    g = gh * heads
    f = lambda *s: rng.normal(size=s).astype(F32)  # noqa: E731
    acum = np.cumsum(-0.2 * rng.uniform(size=(g, t, q)), axis=-1).astype(F32)
    return (f(gh, t, q, n), f(gh, t, q, n), f(g, t, q, 64), acum,
            f(g, t, q, 64), f(g, t, n, 64))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_vjp(c, b, x, acum, dy, dst):
    heads = x.shape[0] // c.shape[0]
    rep = lambda z: jnp.repeat(jnp.asarray(z), heads, axis=0)  # noqa: E731
    _, vjp = jax.vjp(jref.ssd_chunk_ref, rep(c), rep(b), jnp.asarray(x),
                     jnp.asarray(acum))
    jdc, jdb, jdx, jda = vjp((jnp.asarray(dy), jnp.asarray(dst)))
    fold = lambda z: np.asarray(z).reshape(  # noqa: E731
        c.shape[0], heads, *z.shape[1:]).sum(1)
    return fold(jdc), fold(jdb), np.asarray(jdx), np.asarray(jda)


# (batch rows, heads, T, Q, N): mamba2's widths (N 128) and hymba's (N 16)
# at small G and T; Q = 100 and Q = 1, whose rows past Q the kernel
# zero-fills; a 64-token chunk
CASES = [(1, 4, 2, 128, 128), (2, 3, 1, 128, 16), (1, 3, 1, 100, 128),
         (2, 2, 1, 100, 16), (1, 3, 1, 1, 128), (2, 2, 1, 1, 16),
         (1, 2, 2, 64, 128)]


@pytest.mark.parametrize("gh,heads,t,q,n", CASES)
def test_emulation_matches_plain_and_jax_vjp(gh, heads, t, q, n):
    args = _inputs(gh, heads, t, q, n, seed=gh + heads + q + n)
    got = emulate(*args)
    plain = ref.ssd_chunk_bwd_ref(*map(torch.from_numpy, args))
    for name, g_, w_t, w_j in zip(NAMES, got, plain, _jax_vjp(*args)):
        assert g_.shape == tuple(w_t.shape), name
        assert np.isfinite(g_).all(), name
        if float(np.abs(w_j).max()) == 0.0:     # dacum of a one-token chunk
            assert float(np.abs(g_).max()) == 0.0, name
            continue
        assert _rel(g_, w_t.numpy()) <= TOL, (name, _rel(g_, w_t.numpy()))
        assert _rel(g_, w_j) <= TOL, (name, _rel(g_, w_j))


@pytest.mark.parametrize("n", [128, 16])
def test_one_tf32_pass_misses_the_tolerance(n):
    # with the hi hi pass alone (plain tf32) the emulation misses 1e-4 of
    # max in some output, which is why the kernel takes three
    args = _inputs(1, 3, 2, 128, n, seed=n)
    want = ref.ssd_chunk_bwd_ref(*map(torch.from_numpy, args))
    one = emulate(*args, passes=1)
    assert max(_rel(g_, w.numpy()) for g_, w in zip(one, want)) > TOL
    three = emulate(*args)
    assert max(_rel(g_, w.numpy()) for g_, w in zip(three, want)) < TOL


@pytest.mark.parametrize("n", [128, 16])
def test_head_sum_identity(n):
    # dc = sum_h dS_h B = (sum_h dS_h) B and sum_h dS_h^T C = D^T C: the
    # kernel's two score products taken once on D, in float64
    rng = np.random.default_rng(n)
    heads, q = 6, 128
    ds = np.tril(rng.normal(size=(heads, q, q)))
    bm, cm = rng.normal(size=(q, n)), rng.normal(size=(q, n))
    d = ds.sum(0)
    np.testing.assert_allclose(d @ bm, sum(z @ bm for z in ds), rtol=0,
                               atol=1e-12 * np.abs(d @ bm).max())
    np.testing.assert_allclose(d.T @ cm, sum(z.T @ cm for z in ds), rtol=0,
                               atol=1e-12 * np.abs(d.T @ cm).max())


def test_masked_decay_above_the_diagonal_stays_finite():
    # a drops by 200 at one step: above the diagonal exp(a_i - a_j)
    # overflows f32; the kernel selects 0 there, so every output is finite
    args = list(_inputs(1, 2, 1, 64, 16, seed=3))
    args[3] = args[3].copy()
    args[3][..., 32:] -= F32(200)
    with np.errstate(over="ignore"):
        got = emulate(*args)
    want = ref.ssd_chunk_bwd_ref(*map(torch.from_numpy, args))
    for name, g_, w in zip(NAMES, got, want):
        assert np.isfinite(g_).all(), name
        assert _rel(g_, w.numpy()) <= TOL, name
