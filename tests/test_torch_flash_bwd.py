"""The port's flash-attention backward (its plain version, on the CPU)
against the JAX package: ``flash_bwd_ref`` against the Pallas backward
kernels run by the interpreter on the same residuals, and the gradients of
the port's differentiable ``flash_attention`` against ``jax.grad`` of
``flash_attention(backend="interpret")`` and ``backend="ref"``.  Inputs
are made from a seed with numpy.

Tolerances: f32 gradients 2e-4 abs (two f32 backward passes that sum in
different orders over unit-scale inputs); under bf16-saved residuals
2e-2 of the largest gradient, the bound ``tests/test_flash_sparse.py``
holds the JAX package's own residual policy to.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import tiling as jtiling
from repro.kernels.flash import kernel as jkernel
from repro.kernels.flash import ops as jops
from repro_torch.kernels.flash import ops

torch.set_num_threads(2)
TOL = 2e-4
BF16_REL = 2e-2


def _qkv(s, g, d, seed, hkv=2, b=1):
    rng = np.random.default_rng(seed)
    shapes = ((b, hkv * g, s, d), (b, hkv, s, d), (b, hkv, s, d),
              (b, hkv * g, s, d))
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


def _t(x):
    return torch.from_numpy(np.array(x))


# (S, G, D, causal, window, kv_len): S a multiple of the Pallas block, so
# the kernels run unpadded on the same residuals as the port
KERNEL_CASES = [(64, 1, 16, True, 0, None), (128, 4, 64, True, 16, None),
                (256, 2, 16, False, 0, 200), (256, 2, 64, True, 100, None),
                (192, 2, 16, True, 0, 150)]


@pytest.mark.parametrize("s,g,d,causal,window,kv_len", KERNEL_CASES)
def test_plain_backward_matches_pallas_kernels(s, g, d, causal, window,
                                               kv_len):
    q, k, v, do = (x.reshape(-1, s, d) for x in _qkv(s, g, d, seed=s + g))
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    o, m, l = jkernel.flash_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=64, bk=64,
        interpret=True, **kw)
    dq_j, dk_j, dv_j, cq_j, ck_j = jkernel.flash_attention_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, m, l,
        jnp.asarray(do), bq=64, bk=64, interpret=True, debug_counts=True,
        **kw)
    dq, dk, dv = ops.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(o), _t(m), _t(l), _t(do), **kw)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)
    if kv_len is not None:
        assert not dk[:, kv_len:].any() and not dv[:, kv_len:].any()
    # the CUDA kernels' counter twins are the Pallas kernels' own counters
    # at the same 64 x 64 tiles
    twin_q, twin_k = ops.expected_bwd_counts(s, g, **kw)
    assert np.asarray(cq_j).tolist() == [twin_q] * q.shape[0]
    assert np.asarray(ck_j).tolist() == [twin_k] * k.shape[0]


@pytest.mark.parametrize("s,window,kv_len", [(100, 0, None), (300, 100, None),
                                             (130, 0, 70)])
def test_expected_bwd_counts_are_the_tiling_twins(s, window, kv_len):
    n = -(-s // 64) * 64
    kw = dict(bq=64, bk=64, causal=True, window=window,
              kv_len=s if kv_len is None else kv_len)
    twin_q, twin_k = ops.expected_bwd_counts(s, 4, window=window,
                                             kv_len=kv_len)
    assert twin_q == jtiling.kv_visits(n, **kw)
    assert twin_k == [4 * c for c in jtiling.q_visits(n, **kw)]


def _jax_grads(q, k, v, w, *, window, backend, resid_dtype=None):
    def loss(q, k, v):
        out = jops.flash_attention(q, k, v, causal=True, window=window,
                                   backend=backend, resid_dtype=resid_dtype)
        return jnp.sum(out * w)
    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _port_grads(q, k, v, w, *, window, resid_dtype=None):
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*xs, causal=True, window=window,
                              resid_dtype=resid_dtype)
    (out * _t(w)).sum().backward()
    return [x.grad for x in xs]


# (S, G, D, window): ragged S (the JAX side pads to its block and masks),
# GQA groups 1, 2, 4, a sliding window
GRAD_CASES = [(40, 2, 16, 0), (200, 4, 64, 0), (130, 1, 16, 32),
              (64, 4, 64, 16)]


@pytest.mark.parametrize("backend", ["interpret", "ref"])
@pytest.mark.parametrize("s,g,d,window", GRAD_CASES)
def test_flash_attention_grads_match_jax(s, g, d, window, backend):
    q, k, v, w = _qkv(s, g, d, seed=3 * s + g, b=2)
    want = _jax_grads(q, k, v, w, window=window, backend=backend)
    got = _port_grads(q, k, v, w, window=window)
    for a, b_ in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b_.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=TOL,
                                   rtol=0)


def test_bf16_residuals_give_f32_grads_close_to_jax():
    s, g, d = 256, 2, 64
    q, k, v, w = _qkv(s, g, d, seed=11)
    got = _port_grads(q, k, v, w, window=0, resid_dtype=torch.bfloat16)
    for backend, rd in (("interpret", "bfloat16"), ("ref", None)):
        want = _jax_grads(q, k, v, w, window=0, backend=backend,
                          resid_dtype=rd)
        for a, b_ in zip(got, want):
            assert a.dtype == torch.float32
            scale = float(np.abs(np.asarray(b_)).max())
            assert float(np.abs(a.numpy() - np.asarray(b_)).max()) \
                <= BF16_REL * scale


def test_saved_residuals_follow_the_policy():
    q, k, v, _ = (_t(x) for x in _qkv(64, 2, 16, seed=5))
    xs = [x.requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*xs, resid_dtype=torch.bfloat16)
    saved = out.grad_fn.next_functions[0][0].saved_tensors  # under a view
    assert [t.dtype for t in saved] == [torch.bfloat16] * 4 \
        + [torch.float32] * 2
    assert [tuple(t.shape) for t in saved[4:]] == [(4, 64)] * 2


def test_bwd_counts_need_the_kernels():
    x = torch.zeros(2, 8, 16)
    st = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="counts"):
        ops.flash_attention_bwd(x, x, x, x, st, st, x, counts=True)
