"""The tensor-core SSD chunk kernel (``kernels/csrc/ssd_sm90.cu``) on the
CPU: which kernel a CUDA chunk goes to (``ops.ssd_route``), how many heads
a CTA walks (``ops.heads_per_cta``), and whether the kernel's rounding
points fit the tolerance the card holds it to.

The CUDA kernel runs only on the card (``tests/test_torch_cuda_ssm.py``).
Here an emulation of its arithmetic, written with numpy, is held against
the JAX package's ``ssd_chunk_ref`` and its Pallas kernel run by the
interpreter, at 1e-4 of each output's largest value (the tolerance of the
card tests and ``chip_smoke.py``).  The emulation follows the kernel:

* every operand of a product is split x = hi + lo, hi = tf32(x), lo =
  tf32(x - hi), tf32 rounding to nearest on the 10-bit mantissa, ties away
  from zero (``cvt.rna.tf32.f32``'s result; the kernel adds 0x1000 to the
  bits and masks the low 13, as ``tf32`` here does);
* a product is three tf32 passes, hi lo + lo hi + hi hi, each exact
  products summed in f32, the passes summed in f32;
* S = C B^T once per (batch, chunk), shared by the heads of a group;
* G = S exp(da_i - da_j) on and below the diagonal, exactly 0 above it
  (a select: the decay above the diagonal may overflow);
* y = G x; the state = (B o w)^T x at N = 128, and at N = 16 its transpose
  (x' o w)^T B with x' = hi + lo of x read back from x^T; w = exp(da_last
  - da), the exponentials in base 2 of f32 arguments.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import kernel as jkernel
from repro.kernels.ssd import ref as jref
from repro_torch.kernels.ssd import ops, ref

TOL = 1e-4
F32 = np.float32
LOG2E = F32(1.4426950408889634)


@pytest.mark.parametrize("n,p,route", [(128, 64, "sm90"), (16, 64, "sm90"),
                                       (128, 16, "fma"), (16, 16, "fma")])
def test_ssd_route(n, p, route):
    assert ops.ssd_route(n, p) == route


@pytest.mark.parametrize("n,p", [(32, 64), (64, 64), (128, 32), (16, 128)])
def test_ssd_route_raises_for_what_no_kernel_takes(n, p):
    with pytest.raises(ValueError, match="d_state"):
        ops.ssd_route(n, p)


@pytest.mark.parametrize("pairs,heads,sms,group", [
    (128, 24, 132, 24),     # mamba2's serve shape: one CTA a (batch, chunk)
    (128, 25, 132, 25),     # hymba's
    (8, 24, 132, 2),        # a one-chunk prompt of 8 rows: 12 groups of 2
    (2, 24, 132, 1),        # 2 rows: a CTA a head
    (66, 24, 132, 12),      # two groups fill the card
    (256, 24, 132, 24),     # more pairs than SMs: never split the heads
])
def test_heads_per_cta(pairs, heads, sms, group):
    assert ops.heads_per_cta(pairs, heads, sms) == group


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
        # tf32 x tf32 products are exact in f32 (11-bit significands)
        prod = np.matmul(x, y, dtype=F32)
        acc = prod if acc is None else (acc + prod).astype(F32)
    return acc


def exp2_f32(z):
    return np.exp2(np.asarray(z, F32).astype(np.float64)).astype(F32)


def emulate(c, b, x, acum, heads, passes=3):
    """The sm90 kernel's arithmetic: c, b (G/H, T, Q, N); x (G, T, Q, P);
    acum (G, T, Q) -> (y (G, T, Q, P), state (G, T, N, P))."""
    g, t, q, p = x.shape
    n = c.shape[-1]
    s = product3(c, np.swapaxes(b, -1, -2), passes)     # once per (b, t)
    s = np.repeat(s, heads, axis=0)                       # shared by heads
    d = (acum[..., :, None] - acum[..., None, :]).astype(F32)
    live = np.tril(np.ones((q, q), bool))
    gm = np.where(live, s * exp2_f32(d * LOG2E), F32(0)).astype(F32)
    y = product3(gm, x, passes)
    w = exp2_f32((acum[..., -1:] - acum).astype(F32) * LOG2E)   # (G, T, Q)
    bh = np.repeat(b, heads, axis=0)
    if n == 128:
        a = (np.swapaxes(bh, -1, -2) * w[..., None, :]).astype(F32)
        state = product3(a, x, passes)
    else:
        xh, xl = split(x)
        xr = (xh + xl).astype(F32)
        a = (np.swapaxes(xr, -1, -2) * w[..., None, :]).astype(F32)
        state = np.swapaxes(product3(a, bh, passes), -1, -2)
    return y, state


def _inputs(g, t, q, n, p, heads, seed):
    """check_ssd's distribution: normal C, B, x; steps of -U(0, 0.2)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(g // heads, t, q, n)).astype(F32)
    b = rng.normal(size=(g // heads, t, q, n)).astype(F32)
    x = rng.normal(size=(g, t, q, p)).astype(F32)
    acum = np.cumsum(-0.2 * rng.uniform(size=(g, t, q)), axis=-1).astype(F32)
    return c, b, x, acum


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# (G, T, Q, N, heads): mamba2's widths (N 128, P 64) and hymba's (N 16) at
# small G and T; the chunk of a 64-token prompt; Q = 100 and Q = 1, whose
# rows past Q the kernel zero-fills
CASES = [(4, 2, 128, 128, 2), (5, 2, 128, 16, 5), (6, 1, 64, 128, 3),
         (4, 2, 100, 16, 2), (3, 2, 100, 128, 3), (3, 1, 1, 16, 3),
         (2, 1, 1, 128, 1)]


@pytest.mark.parametrize("g,t,q,n,heads", CASES)
def test_emulation_matches_jax_ref_and_interpret(g, t, q, n, heads):
    c, b, x, acum = _inputs(g, t, q, n, 64, heads, seed=g + q + n)
    y, st = emulate(c, b, x, acum, heads)
    cb = [jnp.asarray(np.repeat(z, heads, axis=0)) for z in (c, b)]
    args = (*cb, jnp.asarray(x), jnp.asarray(acum))
    for want_y, want_st in (jref.ssd_chunk_ref(*args),
                            jkernel.ssd_chunk_pallas(*args, interpret=True)):
        assert _rel(y, np.asarray(want_y)) <= TOL
        assert _rel(st, np.asarray(want_st)) <= TOL
    assert np.isfinite(y).all() and np.isfinite(st).all()


@pytest.mark.parametrize("n,heads", [(128, 2), (16, 5)])
def test_one_tf32_pass_misses_the_tolerance(n, heads):
    # the emulation rounds where the kernel does: with the hi hi pass alone
    # (plain tf32) it misses 1e-4 of max, which is why the kernel takes three
    g, q = 2 * heads, 128
    c, b, x, acum = _inputs(g, 2, q, n, 64, heads, seed=n)
    cb = [np.repeat(z, heads, axis=0) for z in (c, b)]
    want_y, want_st = (np.asarray(r) for r in jref.ssd_chunk_ref(
        *map(jnp.asarray, (*cb, x, acum))))
    y1, st1 = emulate(c, b, x, acum, heads, passes=1)
    assert max(_rel(y1, want_y), _rel(st1, want_st)) > TOL
    y3, st3 = emulate(c, b, x, acum, heads)
    assert max(_rel(y3, want_y), _rel(st3, want_st)) < TOL / 10


def test_masked_entries_are_exactly_zero():
    # da drops by 200 at one step: above the diagonal exp(da_i - da_j)
    # overflows f32, and a select (not a product with a 0/1 mask) keeps G
    # at exactly 0 there and y finite
    g, t, q, n, heads = 2, 1, 64, 16, 2
    c, b, x, acum = _inputs(g, t, q, n, 64, heads, seed=3)
    acum[..., 32:] -= F32(200)
    d = (acum[..., :, None] - acum[..., None, :]).astype(F32)
    with np.errstate(over="ignore"):
        decay = exp2_f32(d * LOG2E)
        y, st = emulate(c, b, x, acum, heads)
    assert np.isinf(decay[..., :32, 32:]).all()
    assert np.isfinite(y).all() and np.isfinite(st).all()
    cb = [jnp.asarray(np.repeat(z, heads, axis=0)) for z in (c, b)]
    want_y, want_st = jref.ssd_chunk_ref(*cb, jnp.asarray(x),
                                         jnp.asarray(acum))
    assert _rel(y, np.asarray(want_y)) <= TOL
    assert _rel(st, np.asarray(want_st)) <= TOL


def test_scores_shared_by_a_head_group_equal_per_head_scores():
    # the kernel computes S once for a CTA's heads: the same numbers as S
    # computed for each head from its broadcast copy of C and B
    g, t, q, n, heads = 6, 2, 128, 128, 3
    c, b, x, acum = _inputs(g, t, q, n, 64, heads, seed=11)
    shared = emulate(c, b, x, acum, heads)
    per_head = emulate(np.repeat(c, heads, 0), np.repeat(b, heads, 0), x,
                       acum, 1)
    for a, e in zip(shared, per_head):
        np.testing.assert_array_equal(a, e)


def test_tf32_split_rounds_to_nearest_ties_away():
    one = F32(1)
    ulp = F32(2.0 ** -10)                    # tf32's spacing at 1
    vals = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11),     # ties: away
                     1 + 2.0 ** -11 - 2.0 ** -23,           # below: down
                     1 + 2.0 ** -11 + 2.0 ** -23], F32)     # above: up
    np.testing.assert_array_equal(
        tf32(vals), np.array([one + ulp, -(one + ulp), one, one + ulp], F32))
    x = np.random.default_rng(0).normal(size=4096).astype(F32)
    hi, lo = split(x)
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0)
    assert np.all(lo.view(np.uint32) & 0x1FFF == 0)
    assert np.abs((hi.astype(np.float64) + lo) - x).max() \
        <= 2.0 ** -21 * np.abs(x).max()


def test_cpu_chunk_takes_the_plain_version():
    # on the CPU ssd_chunk is the plain version whatever the route (the
    # kernels need a CUDA tensor), the head-shared B and C broadcast
    c, b, x, acum = map(torch.from_numpy, _inputs(4, 1, 32, 16, 64, 2, 5))
    y, st = ops.ssd_chunk(c, b, x, acum)
    y2, st2 = ref.ssd_chunk_ref(c.repeat_interleave(2, 0),
                                b.repeat_interleave(2, 0), x, acum)
    torch.testing.assert_close(y, y2, atol=0, rtol=0)
    torch.testing.assert_close(st, st2, atol=0, rtol=0)
