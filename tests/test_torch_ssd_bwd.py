"""The SSD chunk's backward (``kernels/ssd``: ``ref.ssd_chunk_bwd_ref`` and
the ``_SSDChunkFn`` autograd wiring that the card runs with
``kernels/csrc/ssd_bwd_sm90.cu`` at head_p 64 and ``ssd_bwd.cu`` at head_p
16) against ``torch.autograd`` through the plain
forward and against ``jax.vjp`` / ``jax.grad`` of the JAX package's
reference, on the CPU, from the same numpy inputs; then the kernel against
the plain backward on the card (marked ``cuda``, skips here; on the H100:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_bwd.py``).

Tolerances, each with its reason:
  * the chunk's gradients: 1e-5 of the largest entry of each, f32 on both
    sides, sums in another order;
  * the whole op's gradients (x, dt, a, b, c, d, initial_state): 1e-4 of
    the largest entry; the recurrence and the y_inter product are rounded
    in another order than JAX's (the port scales the product where JAX
    scales C), and dt / a collect sums over every position;
  * the kernels against the plain backward on the card: 1e-4 of the
    largest entry (f32 FMA or 3xTF32 products in another order, against
    the plain version's f32 einsums).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as jops
from repro.kernels.ssd import ref as jref
from repro_torch.kernels.ssd import ops, ref

torch.set_num_threads(2)
CHUNK_TOL, OP_TOL, CARD_TOL = 1e-5, 1e-4, 1e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1e-30, np.abs(want).max()))


def _chunk_inputs(gh, heads, t, q, n, p, seed):
    """Head-shared c, b (G // H rows), xbar, acum, and the incoming dy,
    dstate, as numpy f32."""
    rng = np.random.default_rng(seed)
    g = gh * heads
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    acum = np.cumsum(-rng.uniform(0.001, 0.2, (g, t, q)).astype(np.float32),
                     axis=-1)
    return (f(gh, t, q, n), f(gh, t, q, n), f(g, t, q, p), acum,
            f(g, t, q, p), f(g, t, n, p))


SHAPES = [(n, p, heads) for n, p in ((16, 16), (16, 64), (128, 64))
          for heads in (1, 3)]


@pytest.mark.parametrize("n,p,heads", SHAPES)
def test_bwd_ref_matches_autograd_and_jax_vjp(n, p, heads):
    c, b, x, acum, dy, dst = _chunk_inputs(2, heads, 2, 32, n, p,
                                           seed=n + p + heads)
    got = ref.ssd_chunk_bwd_ref(*map(torch.from_numpy,
                                     (c, b, x, acum, dy, dst)))
    # torch.autograd through the plain forward, c / b broadcast over heads
    leaves = [torch.from_numpy(z).requires_grad_() for z in (c, b, x, acum)]
    y, st = ref.ssd_chunk_ref(leaves[0].repeat_interleave(heads, 0),
                              leaves[1].repeat_interleave(heads, 0),
                              leaves[2], leaves[3])
    want_t = torch.autograd.grad((y, st), leaves, (torch.from_numpy(dy),
                                                   torch.from_numpy(dst)))
    # jax.vjp of the JAX reference on per-head c / b, summed over the heads
    rep = lambda z: jnp.repeat(jnp.asarray(z), heads, axis=0)  # noqa: E731
    _, vjp = jax.vjp(jref.ssd_chunk_ref, rep(c), rep(b), jnp.asarray(x),
                     jnp.asarray(acum))
    jdc, jdb, jdx, jda = vjp((jnp.asarray(dy), jnp.asarray(dst)))
    fold = lambda z: np.asarray(z).reshape(2, heads, *z.shape[1:]).sum(1)  # noqa: E731
    want_j = (fold(jdc), fold(jdb), jdx, jda)
    for name, g_, wt, wj in zip(("dc", "db", "dxbar", "dacum"), got, want_t,
                                want_j):
        assert g_.shape == wt.shape, name
        assert _rel(g_, wt) <= CHUNK_TOL, (name, _rel(g_, wt))
        assert _rel(g_, wj) <= CHUNK_TOL, (name, _rel(g_, wj))


def test_bwd_ref_at_ragged_and_one_token_chunks():
    # Q not a multiple of 8, and a one-token chunk (dacum is then 0)
    for q in (37, 1):
        c, b, x, acum, dy, dst = _chunk_inputs(1, 2, 1, q, 16, 16, seed=q)
        got = ref.ssd_chunk_bwd_ref(*map(torch.from_numpy,
                                         (c, b, x, acum, dy, dst)))
        leaves = [torch.from_numpy(z).requires_grad_()
                  for z in (c, b, x, acum)]
        y, st = ref.ssd_chunk_ref(leaves[0].repeat_interleave(2, 0),
                                  leaves[1].repeat_interleave(2, 0),
                                  leaves[2], leaves[3])
        want = torch.autograd.grad((y, st), leaves, (torch.from_numpy(dy),
                                                     torch.from_numpy(dst)))
        for g_, w in zip(got, want):
            if float(w.abs().max()) == 0.0:    # dacum of a one-token chunk
                assert float(g_.abs().max()) == 0.0
            else:
                assert _rel(g_.numpy(), w.numpy()) <= CHUNK_TOL


def test_chunk_function_runs_its_backward(monkeypatch):
    # the autograd Function, not autograd through the plain forward, takes
    # the gradient: its backward calls the plain backward on the CPU, as it
    # calls the kernel on the card
    calls = []
    plain = ref.ssd_chunk_bwd_ref

    def counted(*args):
        calls.append(tuple(a.shape for a in args))
        return plain(*args)

    monkeypatch.setattr(ref, "ssd_chunk_bwd_ref", counted)
    c, b, x, acum, dy, dst = map(torch.from_numpy,
                                 _chunk_inputs(2, 3, 2, 32, 16, 16, seed=7))
    leaves = [z.clone().requires_grad_() for z in (c, b, x, acum)]
    y, st = ops.ssd_chunk(*leaves)
    assert y.grad_fn is not None and "SSDChunkFn" in type(y.grad_fn).__name__
    torch.autograd.backward((y, st), (dy, dst))
    assert calls == [(c.shape, b.shape, x.shape, acum.shape, dy.shape,
                      dst.shape)]
    want = plain(c, b, x, acum, dy, dst)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, atol=0, rtol=0)
    # no gradient wanted: the operator alone, no Function
    with torch.no_grad():
        y2, _ = ops.ssd_chunk(*leaves)
    assert y2.grad_fn is None
    torch.testing.assert_close(y2, y.detach(), atol=0, rtol=0)


def test_chunk_operator_has_shapes_on_meta():
    # the planner walks layer functions on device="meta": the fake gives
    # the shapes without running anything
    c = torch.empty((2, 3, 32, 16), device="meta")
    x = torch.empty((6, 3, 32, 64), device="meta")
    acum = torch.empty((6, 3, 32), device="meta")
    y, st = ops.ssd_chunk(c, c, x, acum)
    assert y.device.type == "meta" and tuple(y.shape) == (6, 3, 32, 64)
    assert tuple(st.shape) == (6, 3, 16, 64)


def _seq_inputs(bsz, L, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(bsz, L, h, p)).astype(np.float32),
        dt=rng.uniform(0.001, 0.1, (bsz, L, h)).astype(np.float32),
        a=-rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
        b=rng.normal(size=(bsz, L, n)).astype(np.float32),
        c=rng.normal(size=(bsz, L, n)).astype(np.float32),
        d=rng.normal(size=(h,)).astype(np.float32),
        initial_state=rng.normal(size=(bsz, h, n, p)).astype(np.float32))


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("with_initial", [False, True])
def test_ssd_gradient_matches_jax_grad(return_state, with_initial):
    bsz, L, h, p, n, chunk = 2, 64, 3, 16, 16, 32
    inp = _seq_inputs(bsz, L, h, p, n, seed=11)
    if not with_initial:
        inp.pop("initial_state")
    rng = np.random.default_rng(12)
    wy = rng.normal(size=(bsz, L, h, p)).astype(np.float32)
    ws = rng.normal(size=(bsz, h, n, p)).astype(np.float32)
    names = list(inp)

    def jloss(*vals):
        kw = dict(zip(names, vals))
        out = jops.ssd(kw.pop("x"), kw.pop("dt"), kw.pop("a"), kw.pop("b"),
                       kw.pop("c"), kw.pop("d"), chunk=chunk, backend="ref",
                       return_state=return_state, **kw)
        if return_state:
            return (out[0] * wy).sum() + (out[1] * ws).sum()
        return (out * wy).sum()

    jl, jg = jax.value_and_grad(jloss, argnums=tuple(range(len(names))))(
        *map(jnp.asarray, inp.values()))
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in inp.items()}
    kw = dict(leaves)
    out = ops.ssd(kw.pop("x"), kw.pop("dt"), kw.pop("a"), kw.pop("b"),
                  kw.pop("c"), kw.pop("d"), chunk=chunk,
                  return_state=return_state, **kw)
    loss = ((out[0] * torch.from_numpy(wy)).sum()
            + (out[1] * torch.from_numpy(ws)).sum()) if return_state \
        else (out * torch.from_numpy(wy)).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert abs(float(loss) - float(jl)) <= OP_TOL * abs(float(jl))
    for name, g_, w in zip(names, grads, jg):
        assert _rel(g_.numpy(), w) <= OP_TOL, (name, _rel(g_.numpy(), w))


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("gh,heads,t,q,n,p", [
    (2, 24, 2, 128, 128, 64),     # mamba2's widths, 24 heads a row
    (2, 25, 2, 128, 16, 64),      # hymba's
    (2, 4, 2, 32, 16, 16),        # the smoke configs'
    (3, 2, 1, 100, 128, 16),      # Q not a multiple of 8
    (1, 3, 1, 1, 16, 64),         # a one-token chunk
])
def test_bwd_kernel_matches_plain(dev, gh, heads, t, q, n, p):
    args = [torch.from_numpy(z).to(dev) for z in
            _chunk_inputs(gh, heads, t, q, n, p, seed=q + n + p)]
    # head_p 64 takes the tensor-core kernel, head_p 16 the FMA one
    sm90 = ops.ssd_bwd_route(n, p) == "sm90"
    before = (ops.KERNEL_BWD_SM90.launches, ops.KERNEL_BWD.launches)
    got = ops.ssd_chunk_bwd(*args)
    torch.cuda.synchronize()
    assert (ops.KERNEL_BWD_SM90.launches, ops.KERNEL_BWD.launches) == (
        before[0] + sm90, before[1] + (not sm90))
    want = ref.ssd_chunk_bwd_ref(*args)
    for g_, w in zip(got, want):
        assert _rel(g_.cpu(), w.cpu()) <= CARD_TOL
    # deterministic: the head sum is taken in one order
    again = ops.ssd_chunk_bwd(*args)
    for g_, a in zip(got, again):
        assert torch.equal(g_, a)


@pytest.mark.cuda
def test_ssd_gradient_card_matches_cpu(dev):
    inp = _seq_inputs(2, 256, 4, 64, 128, seed=5)
    wy = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 256, 4, 64)).astype(np.float32))

    def grads(device):
        leaves = [torch.from_numpy(v).to(device).requires_grad_()
                  for v in inp.values()]
        y = ops.ssd(*leaves[:6], chunk=128, initial_state=leaves[6])
        return torch.autograd.grad((y * wy.to(device)).sum(), leaves)

    # head_p 64: the tensor-core forward and backward, not the FMA ones
    kernels = (ops.KERNEL_SM90, ops.KERNEL_BWD_SM90, ops.KERNEL,
               ops.KERNEL_BWD)
    before = [k.launches for k in kernels]
    on_card = grads(dev)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 0, 0]
    for g_, w in zip(on_card, grads("cpu")):
        assert _rel(g_.cpu(), w) <= OP_TOL
    # deterministic: a second call gives the same gradients, bit for bit
    for g_, a in zip(on_card, grads(dev)):
        assert torch.equal(g_, a)
