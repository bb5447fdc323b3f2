"""The port's int8 KV quantization and decode attention against the JAX
package's ``kvq/ref.py`` (the pure-jnp oracles): quantization bit-exact,
decode within 1e-5 abs (f32 softmax over int8-dequantized values, summed
in another order), for splits 1..4 and ragged lengths."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kvq import kernel as jkernel
from repro.kernels.kvq import ref as jref
from repro_torch.kernels.kvq import ops, ref

torch.set_num_threads(2)
TOL = 1e-5


def _cache(b=3, hkv=2, g=2, s=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    k[0, 0, 3] = 0.0                      # all-zero rows -> scale 1.0
    v[1, 1, :5] = 0.0
    kq, ks = jref.quantize_kv(jnp.asarray(k))
    vq, vs = jref.quantize_kv(jnp.asarray(v))
    np_ = lambda x: np.array(x)  # noqa: E731
    return q, np_(kq), np_(ks), np_(vq), np_(vs), k, v


def test_quantize_kv_bit_exact():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 17, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[1, 2, 5, :8] = 0.5 * np.arange(8)   # exact .5 multiples after scaling
    want_q, want_s = jref.quantize_kv(jnp.asarray(x))
    got_q, got_s = ref.quantize_kv(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[0, 0, 0] == 1.0
    np.testing.assert_array_equal(
        ref.dequantize_kv(got_q, got_s).numpy(),
        np.asarray(jref.dequantize_kv(want_q, want_s)))


def test_round_half_to_even():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
    q, s = ref.quantize_kv(x)
    assert s.item() == 1.0
    assert q.tolist() == [[0, 2, 2, 0, -2, 127]]


@pytest.mark.parametrize("lengths", [[64, 64, 64], [1, 37, 64], [5, 2, 63]])
def test_decode_attention_matches_ref(lengths):
    q, kq, ks, vq, vs, _, _ = _cache(seed=len(lengths) + lengths[0])
    b, hkv, g, d = q.shape
    lens = np.asarray(lengths, np.int32)
    want = jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), None, d ** -0.5, lengths=jnp.asarray(lens))
    t = torch.from_numpy
    got = ops.decode_attention(t(q.reshape(b, hkv * g, d)), t(kq), t(ks),
                               t(vq), t(vs), lengths=t(lens))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(b, hkv * g, d),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("block_s", [16, 32])
def test_splitk_ref_matches_jax(splits, block_s):
    q, kq, ks, vq, vs, _, _ = _cache(s=96, seed=splits)
    d = q.shape[-1]
    lens = np.asarray([1, 40, 96], np.int32)
    j = jnp.asarray
    want = jref.decode_attention_splitk_ref(
        j(q), j(kq), j(ks), j(vq), j(vs), d ** -0.5, lengths=j(lens),
        block_s=block_s, splits=splits)
    t = torch.from_numpy
    got = ref.decode_attention_splitk_ref(
        t(q), t(kq), t(ks), t(vq), t(vs), d ** -0.5, lengths=t(lens),
        block_s=block_s, splits=splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    exact = ref.decode_attention_ref(t(q), t(kq), t(ks), t(vq), t(vs), None,
                                     d ** -0.5, lengths=t(lens))
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=TOL, rtol=0)


def test_combine_splits_with_dead_split():
    rng = np.random.default_rng(7)
    b, hkv, n_sp, g, d = 2, 2, 3, 2, 8
    o_p = rng.standard_normal((b, hkv, n_sp, g, d)).astype(np.float32)
    m_p = rng.standard_normal((b, hkv, n_sp, g)).astype(np.float32)
    l_p = rng.uniform(0.5, 2.0, (b, hkv, n_sp, g)).astype(np.float32)
    o_p[:, :, 2] = 0.0                    # the last split saw no live tile
    m_p[:, :, 2] = -1e30
    l_p[:, :, 2] = 0.0
    want = jkernel.combine_splits(jnp.asarray(o_p), jnp.asarray(m_p),
                                  jnp.asarray(l_p), jnp.float32)
    t = torch.from_numpy
    got = ref.combine_splits(t(o_p), t(m_p), t(l_p), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    live = ref.combine_splits(t(o_p[:, :, :2]), t(m_p[:, :, :2]),
                              t(l_p[:, :, :2]), torch.float32)
    np.testing.assert_allclose(got.numpy(), live.numpy(), atol=1e-7, rtol=0)


def test_unquantized_logits_match_jax():
    q, _, _, _, _, k, _ = _cache(seed=4)
    lens = np.asarray([3, 64, 10], np.int32)
    want = jref.masked_decode_logits(jnp.asarray(q), jnp.asarray(k), 0.25,
                                     None, jnp.asarray(lens))
    got = ref.masked_decode_logits(torch.from_numpy(q), torch.from_numpy(k),
                                   0.25, None, torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_counts_need_the_kernel():
    q, kq, ks, vq, vs, _, _ = _cache()
    t = torch.from_numpy
    with pytest.raises(ValueError, match="counts"):
        ops.decode_attention(t(q.reshape(3, 4, 16)), t(kq), t(ks), t(vq),
                             t(vs), counts=True)


def _band_bias(b, s, pos, window):
    """(B, S) f32: 0 inside the window band ending at each row's pos,
    -1e30 elsewhere (what a windowed layer's decode builds)."""
    kv = np.arange(s)[None, :]
    p = np.asarray(pos)[:, None]
    ok = (kv <= p) & (kv > p - window)
    return np.where(ok, 0.0, -1e30).astype(np.float32)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_bias_decode_matches_jax(splits):
    # bands that leave whole splits with only -1e30 entries
    q, kq, ks, vq, vs, _, _ = _cache(s=96, seed=10 + splits)
    b, hkv, g, d = q.shape
    bias = _band_bias(b, 96, [95, 40, 20], window=16)
    j, t = jnp.asarray, torch.from_numpy
    want = jref.decode_attention_ref(j(q), j(kq), j(ks), j(vq), j(vs),
                                     j(bias), d ** -0.5)
    got = ops.decode_attention(t(q.reshape(b, hkv * g, d)), t(kq), t(ks),
                               t(vq), t(vs), bias=t(bias))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(b, hkv * g, d),
                               atol=TOL, rtol=0)
    want_sk = jref.decode_attention_splitk_ref(
        j(q), j(kq), j(ks), j(vq), j(vs), d ** -0.5, bias=j(bias),
        block_s=16, splits=splits)
    got_sk = ref.decode_attention_splitk_ref(
        t(q), t(kq), t(ks), t(vq), t(vs), d ** -0.5, bias=t(bias),
        block_s=16, splits=splits)
    assert np.isfinite(got_sk.numpy()).all()
    np.testing.assert_allclose(got_sk.numpy(), np.asarray(want_sk),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got_sk.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_causal_bias_equals_lengths():
    # a global layer: the JAX package's traced-window decode masks it with
    # a causal bias, the port with lengths = pos + 1; the same numbers
    q, kq, ks, vq, vs, _, _ = _cache(seed=12)
    b, hkv, g, d = q.shape
    pos = np.asarray([63, 7, 30], np.int32)
    bias = _band_bias(b, 64, pos, window=10 ** 6)
    t = torch.from_numpy
    args = (t(q.reshape(b, hkv * g, d)), t(kq), t(ks), t(vq), t(vs))
    by_bias = ops.decode_attention(*args, bias=t(bias))
    by_len = ops.decode_attention(*args, lengths=t(pos + 1))
    np.testing.assert_allclose(by_bias.numpy(), by_len.numpy(), atol=1e-6,
                               rtol=0)
    with pytest.raises(ValueError, match="exclusive"):
        ops.decode_attention(*args, bias=t(bias), lengths=t(pos + 1))
