"""The port's gradient codec (``repro_torch.optim.compression``) against
the JAX package's.

Top-k is deterministic, so its payload and residual are held exactly
(inputs without ties in magnitude).  The int8 codec's rounding noise
comes from ``torch.Generator`` where the reference draws from
``jax.random``, so the codes are held by what the noise cannot change:
the scale is equal, every code is within 1 of ``x / scale`` (the floor or
the ceiling, never further), and the reference's three properties hold
(``tests/test_distributed.py:77-105``: an unbiased round trip, error
feedback that removes the bias, a small top-k payload), with the
reference's own bounds.  ``payload_bytes`` is equal for both codecs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro_torch.optim import compression as comp


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    # magnitudes without ties (a permutation of distinct values, signs)
    w = rng.permutation(np.linspace(0.01, 3.0, 24 * 16)).reshape(24, 16)
    w = w * rng.choice([-1.0, 1.0], size=w.shape)
    b = rng.permutation(np.linspace(0.02, 1.0, 40)) * rng.choice(
        [-1.0, 1.0], size=40)
    return {"w": w.astype(np.float32), "b": b.astype(np.float32),
            "a": np.zeros((5,), np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.3])
def test_topk_payload_and_residual_equal_jax(frac):
    g = {k: v for k, v in _grads().items() if k != "a"}   # "a": all ties
    rng = np.random.default_rng(1)
    res = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
           for k, v in g.items()}
    jp, jr = jcomp.compress_with_feedback(_j(g), _j(res), jax.random.PRNGKey(0),
                                          codec="topk", topk_frac=frac)
    tp, tr = comp.compress_with_feedback(_t(g), _t(res), 0, codec="topk",
                                         topk_frac=frac)
    assert set(tp) == set(jp)
    for k in g:
        jv, ji = jp[k]
        tv, ti = tp[k]
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]))
    assert comp.payload_bytes(tp) == jcomp.payload_bytes(jp)
    like = _t(g)
    back = comp.decompress(tp, like, codec="topk")
    jback = jcomp.decompress(jp, _j(g), codec="topk")
    for k in g:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_scale_equal_and_codes_within_one(seed):
    g = _grads(seed)
    jp, _ = jcomp.compress_with_feedback(_j(g), None, jax.random.PRNGKey(seed))
    tp, tr = comp.compress_with_feedback(_t(g), None, seed)
    assert comp.payload_bytes(tp) == jcomp.payload_bytes(jp)
    for k, x in g.items():
        q, s = tp[k]
        jq, js = jp[k]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert float(s) == float(js)
        exact = x / np.float32(float(s))
        assert np.all(np.abs(q.numpy().astype(np.float64) - exact) <= 1.0)
        assert np.all(np.abs(np.asarray(jq).astype(np.float64) - exact)
                      <= 1.0)
        # the residual is what the codes did not carry
        np.testing.assert_allclose(
            tr[k].numpy(), x - comp.dequantize_int8(q, s).numpy(), atol=0)
    assert float(tp["a"][1]) == 1.0 and not tp["a"][0].any()  # all zero
    back = comp.decompress(tp, _t(g))
    for k in g:
        np.testing.assert_array_equal(
            back[k].numpy(), comp.dequantize_int8(*tp[k]).numpy())


def test_int8_unbiased_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=512)
                         .astype(np.float32) * 3)
    outs = [comp.dequantize_int8(*comp.quantize_int8(
        x, comp.generator_for(x, i))).numpy() for i in range(50)]
    err = np.abs(np.mean(outs, axis=0) - x.numpy())
    assert err.max() < 0.05     # stochastic rounding -> unbiased mean


def test_int8_rounds_half_to_even_without_noise():
    """With the noise pinned at 0 the codes are ``round``: half to even,
    as ``jnp.round``."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    gen = torch.Generator().manual_seed(0)
    orig = torch.rand
    try:
        torch.rand = lambda shape, **kw: torch.full(shape, 0.5)
        q, s = comp.quantize_int8(x, gen)
    finally:
        torch.rand = orig
    jq = jnp.round(jnp.asarray(x.numpy()) / 1.0).astype(jnp.int8)
    assert float(s) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist() == [127, 0, 2, 2, 0, -2]


def test_error_feedback_reduces_bias():
    grads = {"w": torch.linspace(-1, 1, 256)}
    res = None
    recon_sum = torch.zeros(256)
    for i in range(20):
        payload, res = comp.compress_with_feedback(grads, res, i)
        recon_sum += comp.dequantize_int8(*payload["w"])
    np.testing.assert_allclose((recon_sum / 20).numpy(),
                               grads["w"].numpy(), atol=0.02)


def test_topk_payload_smaller():
    grads = {"w": torch.ones(1000)}
    payload, _ = comp.compress_with_feedback(grads, None, 0, codec="topk",
                                             topk_frac=0.01)
    assert comp.payload_bytes(payload) < 1000 * 4 * 0.05
    jpay, _ = jcomp.compress_with_feedback({"w": jnp.ones(1000)}, None,
                                           jax.random.PRNGKey(0),
                                           codec="topk", topk_frac=0.01)
    assert comp.payload_bytes(payload) == jcomp.payload_bytes(jpay)


def test_leaves_draw_distinct_noise_and_unknown_codec_raises():
    x = torch.full((4096,), 0.37)
    x[0] = 1.0                  # codes of 0.37 * 127 = 46.99: 46 or 47
    g = {"a": x, "b": x.clone()}
    p, _ = comp.compress_with_feedback(g, None, 7)
    assert not torch.equal(p["a"][0], p["b"][0])   # seeded from (seed, i)
    p2, _ = comp.compress_with_feedback(g, None, 7)
    assert torch.equal(p["a"][0], p2["a"][0])      # and reproducible
    with pytest.raises(ValueError):
        comp.compress_with_feedback(g, None, 0, codec="fp8")
