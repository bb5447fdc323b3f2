"""The tensor-core forward (``kernels/csrc/flash_fwd_sm90.cu``) on the
CPU: which kernel a CUDA forward goes to (``ops.fwd_route``), whether the
kernel's rounding points fit the bf16 tolerance, and the counter twins of
the shapes the card tests run.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``).
Here an emulation of its arithmetic, written with numpy, is held against
the JAX package's Pallas forward run by the interpreter: bf16 q, k, v;
f32 scores (wgmma multiplies bf16 exactly and sums in f32); the online
softmax over 64-column KV tiles in exp2 units (the running max taken over
the raw scores and scaled by scale * log2 e, p = 2^(s scale log2 e - m)
with one rounding), masked p exactly 0; P rounded to bf16 before P V; l
summed from the f32 p; o rounded to bf16.
The tolerance is the one the card holds the kernel to: 2e-2 on o, 1e-3
on m and on l relative.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import tiling as jtiling
from repro.kernels.flash import kernel as jkernel
from repro_torch.kernels import tiling
from repro_torch.kernels.flash import ops, ref

torch.set_num_threads(2)
O_TOL, M_TOL, L_REL = 2e-2, 1e-3, 1e-3
F32, BF, F16 = torch.float32, torch.bfloat16, torch.float16
LOG2E = np.float32(1.4426950408889634)
NEG_INF = np.float32(-1e30)


@pytest.mark.parametrize("dtype,d,route", [
    (BF, 128, "sm90"), (BF, 64, "sm90"), (BF, 16, "fma"),
    (F32, 128, "fma"), (F32, 64, "fma"), (F32, 16, "fma"),
    (BF, 160, "sm90"), (F32, 160, "fma")])
def test_fwd_route(dtype, d, route):
    assert ops.fwd_route(dtype, d) == route


@pytest.mark.parametrize("dtype,d,exc", [
    (F16, 128, TypeError), (torch.int8, 64, TypeError),
    (BF, 32, ValueError), (BF, 96, ValueError), (F32, 256, ValueError),
    (F32, 96, ValueError), (BF, 256, ValueError)])
def test_fwd_route_raises_for_what_no_kernel_takes(dtype, d, exc):
    with pytest.raises(exc):
        ops.fwd_route(dtype, d)


def _bf16(x):
    """Round an f32 array to bf16 (nearest even) and back."""
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16) \
        .float().numpy()


def _emulate_sm90(q, k, v, *, causal, window, kv_len, scale):
    """The sm90 kernel's arithmetic, tile by tile: inputs bf16-valued f32
    (BH, S, D) / (BHkv, S, D) -> (o, m, l).  Tiles are staged as 64-column
    panels, D rounded up to a whole panel with the zeros TMA fills past
    the tensor's edge (columns 160..191 at D = 160); o keeps D columns."""
    bh, s, d0 = q.shape
    g = bh // k.shape[0]
    n = -(-s // 64) * 64
    d = -(-d0 // 64) * 64
    pad = lambda x: np.pad(x, ((0, 0), (0, n - s), (0, d - d0)))  # noqa
    q, k, v = pad(q), pad(k), pad(v)
    scale2 = np.float32(scale) * LOG2E
    pos = np.arange(n)
    o = np.zeros((bh, n, d), np.float32)
    m = np.full((bh, n), NEG_INF, np.float32)
    l = np.zeros((bh, n), np.float32)
    for h in range(bh):
        for qi in range(n // 64):
            rows = slice(64 * qi, 64 * qi + 64)
            lo, hi = tiling.kv_tile_bounds(qi, bq=64, bk=64, causal=causal,
                                           window=window, kv_len=kv_len)
            m2 = np.full(64, NEG_INF, np.float32)
            acc = np.zeros((64, d), np.float32)
            lsum = np.zeros(64, np.float32)
            for kt in range(lo, hi + 1):
                cols = slice(64 * kt, 64 * kt + 64)
                sc = q[h, rows] @ k[h // g, cols].T
                qp, kp = pos[rows][:, None], pos[cols][None, :]
                ok = (qp < s) & (kp < kv_len)
                if causal:
                    ok &= qp >= kp
                    if window > 0:
                        ok &= qp - kp < window
                sc = np.where(ok, sc, -np.inf).astype(np.float32)
                # the max of the raw scores, scaled once; p = 2^(s scale2
                # - m2) with one rounding (an FMA)
                m_new = np.maximum(m2, sc.max(-1) * scale2)
                alpha = np.exp2(m2 - m_new)
                p = np.exp2((sc.astype(np.float64) * scale2
                             - m_new[:, None]).astype(np.float32))
                lsum = lsum * alpha + p.sum(-1, dtype=np.float32)
                acc = acc * alpha[:, None] + _bf16(p) @ v[h // g, cols]
                m2 = m_new
            o[h, rows] = acc / np.maximum(lsum, np.float32(1e-30))[:, None]
            m[h, rows] = np.where(m2 == NEG_INF, NEG_INF, m2 / LOG2E)
            l[h, rows] = lsum
    return _bf16(o[:, :s, :d0]), m[:, :s], l[:, :s]


def _pallas_fwd(q, k, v, *, causal, window, kv_len):
    """The Pallas forward (interpret) on bf16 inputs; S padded with zeros
    to a multiple of 64 where the kernel needs it, keys past ``kv_len``
    masked, rows past S dropped."""
    s = q.shape[1]
    n = s if s < 64 else -(-s // 64) * 64
    pad = lambda x: jnp.asarray(np.pad(  # noqa: E731
        x, ((0, 0), (0, n - s), (0, 0))), jnp.bfloat16)
    o, m, l = jkernel.flash_attention_fwd_pallas(
        pad(q), pad(k), pad(v), causal=causal, window=window, kv_len=kv_len,
        bq=64, bk=64, interpret=True)
    return (np.asarray(o, np.float32)[:, :s], np.asarray(m)[:, :s],
            np.asarray(l)[:, :s])


# (S, G, D, causal, window, kv_len): S 1, 63, 100 and 257; G 1 and 4; D 64,
# 128 and 160 (three panels, the last half zeros); causal, windowed (the
# first tiles of a band start with dead rows), kv_len < S, non-causal; one
# KV head
EMU_CASES = [(1, 4, 128, True, 0, None), (1, 1, 64, False, 0, None),
             (63, 1, 64, True, 0, None), (63, 4, 128, False, 0, 40),
             (100, 4, 64, True, 0, None), (100, 1, 128, True, 16, None),
             (100, 4, 128, False, 0, 70), (257, 1, 64, True, 100, None),
             (257, 4, 128, True, 0, 200), (257, 1, 128, False, 0, None),
             (257, 4, 64, True, 64, 250), (257, 1, 64, False, 0, 1),
             (100, 4, 160, True, 0, None), (257, 1, 160, True, 100, 200),
             (63, 4, 160, False, 0, 40)]


@pytest.mark.parametrize("s,g,d,causal,window,kv_len", EMU_CASES)
def test_sm90_rounding_fits_the_bf16_tolerance(s, g, d, causal, window,
                                               kv_len):
    rng = np.random.default_rng(s + 10 * g + d + window)
    q = _bf16(rng.standard_normal((g, s, d)))
    k, v = (_bf16(rng.standard_normal((1, s, d))) for _ in range(2))
    kvl = s if kv_len is None else kv_len
    kw = dict(causal=causal, window=window, kv_len=kvl)
    o_j, m_j, l_j = _pallas_fwd(q, k, v, **kw)
    o, m, l = _emulate_sm90(q, k, v, scale=d ** -0.5, **kw)
    assert np.isfinite(o).all() and np.isfinite(m).all()
    assert float(np.abs(o - o_j).max()) <= O_TOL
    assert float(np.abs(m - m_j).max()) <= M_TOL
    assert float((np.abs(l - l_j) / l_j).max()) <= L_REL


def test_emulation_writes_zeros_for_rows_with_no_live_key():
    """kv_len = 0, non-causal: o = 0, m = -1e30, l = 0, as the FMA kernel
    writes them (its KV loop runs no tile)."""
    rng = np.random.default_rng(3)
    q, k, v = (_bf16(rng.standard_normal((1, 70, 64))) for _ in range(3))
    o, m, l = _emulate_sm90(q, k, v, causal=False, window=0, kv_len=0,
                            scale=0.125)
    assert not o.any() and not l.any() and (m == NEG_INF).all()


# the (S, G, causal, window, kv_len) of tests/test_torch_cuda.py's bf16
# forward rows
CARD_SHAPES = [(1, 4, True, 0, None), (63, 1, True, 0, None),
               (65, 8, True, 16, None), (100, 4, False, 0, 70),
               (257, 1, True, 100, None), (257, 8, True, 0, 200),
               (1024, 4, True, 0, None), (1024, 8, True, 1000, None),
               (257, 4, False, 0, None), (1024, 1, False, 0, 700)]


@pytest.mark.parametrize("s,g,causal,window,kv_len", CARD_SHAPES)
def test_expected_counts_match_jax_tiling(s, g, causal, window, kv_len):
    n = -(-s // 64) * 64
    assert ops.expected_counts(s, causal=causal, window=window,
                               kv_len=kv_len) == jtiling.kv_visits(
        n, bq=64, bk=64, causal=causal, window=window,
        kv_len=s if kv_len is None else kv_len)


@pytest.mark.parametrize("dtype,d", [(BF, 128), (BF, 64), (BF, 16),
                                     (F32, 64), (BF, 160), (F32, 160)])
def test_cpu_forward_stays_plain_for_every_route(dtype, d):
    """On the CPU every route, the sm90 one included, is the plain
    version: no kernel counter moves."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, 70, d))
                                .astype(np.float32)).to(dtype)
               for n in (4, 2, 2))
    before = (ops.KERNEL.launches, ops.FWD_SM90.launches)
    got = ops.flash_attention_fwd(q, k, v, window=16)
    want = ref.flash_fwd_ref(q, k, v, window=16)
    assert (ops.KERNEL.launches, ops.FWD_SM90.launches) == before
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
