"""The port's SSD op (``kernels/ssd``) against the JAX package's, on the
CPU, from the same numpy inputs: the plain chunk version against JAX's
``ssd_chunk_ref`` and its Pallas kernel in interpret mode (atol 1e-5, f32
sums in another order), the chunked op against the sequential recurrence
at the JAX test's shapes (atol 5e-4 / rtol 2e-3, the JAX test's
tolerance), against the JAX op itself (1e-5), the decode step, and the
``L % chunk`` contract."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import kernel as jkernel
from repro.kernels.ssd import ops as jops
from repro.kernels.ssd import ref as jref
from repro_torch.kernels.ssd import ops, ref

torch.set_num_threads(2)


def _chunk_inputs(g, t, q, n, p, seed):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(g, t, q, n)).astype(np.float32)
    b = rng.normal(size=(g, t, q, n)).astype(np.float32)
    x = rng.normal(size=(g, t, q, p)).astype(np.float32)
    acum = np.cumsum(-rng.uniform(0.001, 0.2, (g, t, q)).astype(np.float32),
                     axis=-1)
    return c, b, x, acum


@pytest.mark.parametrize("g,t,q,n,p", [(4, 4, 64, 32, 16),
                                       (2, 2, 128, 128, 64),
                                       (3, 1, 100, 16, 64)])
def test_chunk_ref_matches_jax_ref_and_interpret(g, t, q, n, p):
    args = _chunk_inputs(g, t, q, n, p, seed=q + n)
    y, st = ref.ssd_chunk_ref(*map(torch.from_numpy, args))
    jy, jst = jref.ssd_chunk_ref(*map(jnp.asarray, args))
    ky, kst = jkernel.ssd_chunk_pallas(*map(jnp.asarray, args),
                                       interpret=True)
    for got, want in ((y, jy), (st, jst), (y, ky), (st, kst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_chunk_op_takes_head_shared_b_c():
    # (G // H) rows of B and C serve H folded rows each, as on the card
    c, b, x, acum = map(torch.from_numpy, _chunk_inputs(6, 2, 32, 16, 16, 1))
    heads = 3
    y, st = ops.ssd_chunk(c[:2], b[:2], x, acum)
    y_r, st_r = ref.ssd_chunk_ref(c[:2].repeat_interleave(heads, 0),
                                  b[:2].repeat_interleave(heads, 0), x, acum)
    torch.testing.assert_close(y, y_r, atol=0, rtol=0)
    torch.testing.assert_close(st, st_r, atol=0, rtol=0)


def _seq_inputs(b, L, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, L, h, p)).astype(np.float32),
            rng.uniform(0.001, 0.1, (b, L, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
            rng.normal(size=(b, L, n)).astype(np.float32),
            rng.normal(size=(b, L, n)).astype(np.float32),
            rng.normal(size=(h,)).astype(np.float32))


@pytest.mark.parametrize("b,L,h,p,n,q", [
    (1, 128, 2, 16, 32, 32),
    (2, 256, 3, 16, 32, 64),
    (2, 256, 4, 64, 128, 128),   # production-like dims
])
def test_chunked_matches_sequential_and_jax(b, L, h, p, n, q):
    args = _seq_inputs(b, L, h, p, n, seed=L + q)
    t_args = tuple(map(torch.from_numpy, args))
    y, state = ops.ssd(*t_args, chunk=q, return_state=True)
    y_seq = jref.ssd_scan_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_seq), atol=5e-4,
                               rtol=2e-3)
    np.testing.assert_allclose(ref.ssd_scan_ref(*t_args).numpy(),
                               np.asarray(y_seq), atol=5e-4, rtol=2e-3)
    jy, jstate = jops.ssd(*map(jnp.asarray, args), chunk=q,
                          return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), atol=1e-5)


def test_initial_state_continues_the_scan():
    args = _seq_inputs(2, 128, 2, 16, 16, seed=5)
    t_args = tuple(map(torch.from_numpy, args))
    s0 = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 2, 16, 16)).astype(np.float32))
    y, st = ops.ssd(*t_args, chunk=32, initial_state=s0, return_state=True)
    jy, jst = jops.ssd(*map(jnp.asarray, args), chunk=32,
                       initial_state=jnp.asarray(s0.numpy()),
                       return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-5)


def test_decode_step_matches_jax():
    rng = np.random.default_rng(8)
    b, h, p, n = 2, 3, 8, 16
    state = rng.normal(size=(b, h, n, p)).astype(np.float32)
    x = rng.normal(size=(b, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, (b, h)).astype(np.float32)
    a = -rng.uniform(0.5, 1.0, (h,)).astype(np.float32)
    bt = rng.normal(size=(b, n)).astype(np.float32)
    ct = rng.normal(size=(b, n)).astype(np.float32)
    d = rng.normal(size=(h,)).astype(np.float32)
    args = (state, x, dt, a, bt, ct, d)
    st, y = ops.ssd_decode_step(*map(torch.from_numpy, args))
    jst, jy = jops.ssd_decode_step(*map(jnp.asarray, args))
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)


def test_decode_steps_continue_a_prefill():
    # prefill 64 tokens through the chunked op, then 16 decode steps from
    # its final state: together they equal the sequential recurrence
    args = _seq_inputs(2, 80, 2, 16, 16, seed=11)
    x, dt, a, bm, cm, d = map(torch.from_numpy, args)
    _, state = ops.ssd(x[:, :64], dt[:, :64], a, bm[:, :64], cm[:, :64], d,
                       chunk=32, return_state=True)
    y_seq = ref.ssd_scan_ref(x, dt, a, bm, cm, d)
    for t in range(64, 80):
        state, y_t = ops.ssd_decode_step(state, x[:, t], dt[:, t], a,
                                         bm[:, t], cm[:, t], d)
        np.testing.assert_allclose(y_t.numpy(), y_seq[:, t].numpy(),
                                   atol=1e-4, rtol=1e-3)


def test_length_must_be_a_multiple_of_the_chunk():
    x, dt, a, bm, cm, d = map(torch.from_numpy,
                              _seq_inputs(1, 100, 2, 16, 16, seed=0))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd(x, dt, a, bm, cm, d, chunk=32)
