"""The port's flash-attention op (its plain version, on the CPU) against
the JAX package's ``flash_attention(backend="interpret")``: the same numpy
inputs through both, f32, tolerance 1e-4 abs (two f32 softmaxes that sum
in different orders).  Where the Pallas kernel takes S unpadded (S <= 128
or a multiple of 128) the row statistics m and l are held against
``flash_attention_fwd_pallas(..., interpret=True)`` too."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import kernel as jkernel
from repro.kernels.flash import ops as jops
from repro_torch.kernels.flash import ops

torch.set_num_threads(2)
TOL = 1e-4

# (S, G, window, D): every S in {8, 40, 128, 200}, G in {1, 2, 4}, window
# 0 and 16, D in {16, 64}, without the full product
CASES = [(8, 1, 0, 16), (8, 4, 16, 64), (40, 2, 16, 16), (40, 4, 0, 64),
         (128, 1, 16, 64), (128, 4, 0, 16), (200, 2, 0, 64),
         (200, 1, 16, 16)]


def _inputs(s, g, d, seed, hkv=2, b=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv * g, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("s,g,window,d", CASES)
def test_flash_attention_matches_interpret(s, g, window, d):
    q, k, v = _inputs(s, g, d, seed=s * 10 + g)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, backend="interpret"))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              window=window).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("s,g,window,d", [c for c in CASES
                                          if c[0] <= 128 or c[0] % 128 == 0])
def test_row_stats_match_pallas_kernel(s, g, window, d):
    q, k, v = _inputs(s, g, d, seed=s + g, b=2)
    b, h = q.shape[:2]
    flat = lambda x: x.reshape(-1, s, d)  # noqa: E731
    o_j, m_j, l_j = jkernel.flash_attention_fwd_pallas(
        jnp.asarray(flat(q)), jnp.asarray(flat(k)), jnp.asarray(flat(v)),
        causal=True, window=window, interpret=True)
    o, m, l = ops.flash_attention_fwd(
        torch.from_numpy(flat(q)), torch.from_numpy(flat(k)),
        torch.from_numpy(flat(v)), causal=True, window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_j), rtol=TOL, atol=0)


def test_kv_len_masks_padded_keys():
    s, d = 40, 16
    q, k, v = (x.reshape(-1, s, d) for x in _inputs(s, 2, d, seed=3))
    o_j, m_j, l_j = jkernel.flash_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        kv_len=29, interpret=True)
    o, m, l = ops.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=False, kv_len=29)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_j), rtol=TOL, atol=0)


def test_gqa_mismatch_raises():
    q = torch.zeros(1, 3, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="GQA"):
        ops.flash_attention(q, k, k)


def test_counts_need_the_kernel():
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="counts"):
        ops.flash_attention_fwd(x, x, x, counts=True)


@pytest.mark.parametrize("s,window", [(16, 0), (100, 0), (1024, 0),
                                      (300, 100)])
def test_expected_counts_are_the_tiling_twin(s, window):
    # the kernel runs 64-row tiles over S padded to 64; its counters are
    # held against tiling.kv_visits on that padded length
    from repro.kernels import tiling as jt
    n_q = -(-s // 64)
    want = jt.kv_visits(n_q * 64, bq=64, bk=64, causal=True, window=window,
                        kv_len=s)
    assert ops.expected_counts(s, window=window) == want
    assert len(want) == n_q
