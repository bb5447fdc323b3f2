"""The tensor-core backward (``kernels/csrc/flash_bwd_sm90.cu``) on the
CPU: which kernels a CUDA backward goes to (``ops.bwd_route``), whether
the kernels' rounding points fit the bf16 tolerance, and the counter
twins of the shapes the card tests run.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``).
Here an emulation of their arithmetic, written with numpy, is held
against the JAX package's Pallas backward run by the interpreter:
bf16 q, k, v, dO and o; f32 products (wgmma multiplies bf16 exactly and
sums in f32); P and dS rounded to bf16 before the second-stage products
(they are the A operands of dV += P^T dO, dK += dS^T Q and dQ += dS K);
f32 sums of those products; bf16 gradients.  The tolerance is the one
the card holds the kernels to: 2e-2 of the largest gradient.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import tiling as jtiling
from repro.kernels.flash import kernel as jkernel
from repro_torch.kernels.flash import ops

torch.set_num_threads(2)
BF16_REL = 2e-2
F32, BF, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("combo,d,route", [
    ((BF, BF, BF), 128, "sm90"), ((BF, BF, BF), 64, "sm90"),
    ((BF, BF, BF), 16, "fma"),
    ((F32, F32, F32), 128, "fma"), ((F32, F32, F32), 64, "fma"),
    ((F32, F32, F32), 16, "fma"),
    ((BF, F32, F32), 128, "fma"), ((BF, F32, F32), 64, "fma"),
    ((BF, BF, BF), 160, "sm90"), ((F32, F32, F32), 160, "fma"),
    ((BF, F32, F32), 160, "fma"),
])
def test_bwd_route(combo, d, route):
    assert ops.bwd_route(*combo, d) == route


@pytest.mark.parametrize("combo,d,exc", [
    ((F16, F16, F16), 128, TypeError), ((BF, BF, F32), 128, TypeError),
    ((F32, BF, BF), 64, TypeError), ((BF, BF, BF), 32, ValueError),
    ((F32, F32, F32), 256, ValueError), ((BF, BF, BF), 96, ValueError),
    ((F32, F32, F32), 96, ValueError), ((BF, BF, BF), 256, ValueError),
])
def test_bwd_route_raises_for_what_no_kernel_takes(combo, d, exc):
    with pytest.raises(exc):
        ops.bwd_route(*combo, d)


def _bf16(x):
    """Round an f32 array to bf16 (nearest even) and back."""
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16) \
        .float().numpy()


def _mask(s, causal, window, kv_len):
    qpos = np.arange(s)[:, None]
    kpos = np.arange(s)[None, :]
    ok = kpos < kv_len
    if causal:
        ok = ok & (qpos >= kpos)
        if window > 0:
            ok = ok & (qpos - kpos < window)
    return ok


def _emulate_sm90(q, k, v, o, m, l, do, *, causal, window, kv_len, scale):
    """The sm90 kernels' arithmetic: inputs already bf16-valued f32.  Tiles
    are staged as 64-column panels, D rounded up to a whole panel with the
    zeros TMA fills past the tensor's edge (columns 160..191 at D = 160);
    the gradients keep D columns."""
    d0 = q.shape[-1]
    if d0 % 64:
        pad = lambda x: np.pad(  # noqa: E731
            x, ((0, 0), (0, 0), (0, -(-d0 // 64) * 64 - d0)))
        got = _emulate_sm90(pad(q), pad(k), pad(v), pad(o), m, l, pad(do),
                            causal=causal, window=window, kv_len=kv_len,
                            scale=scale)
        return tuple(x[..., :d0] for x in got)
    bh, s, d = q.shape
    g = bh // k.shape[0]
    ok = _mask(s, causal, window, kv_len)
    delta = (o * do).sum(-1, dtype=np.float32)          # the delta kernel
    lse = m + np.log(np.maximum(l, 1e-30))
    dq = np.zeros_like(q)
    dk = np.zeros_like(k)
    dv = np.zeros_like(v)
    for h in range(bh):
        kh = h // g
        sc = q[h] @ k[kh].T
        p = np.exp(np.where(ok, sc * scale - lse[h][:, None], -np.inf)) \
            .astype(np.float32)
        dp = do[h] @ v[kh].T
        ds = (p * (dp - delta[h][:, None])).astype(np.float32)
        p16, ds16 = _bf16(p), _bf16(ds)
        dq[h] = ds16 @ k[kh]
        dk[kh] += ds16.T @ q[h]
        dv[kh] += p16.T @ do[h]
    return _bf16(dq * scale), _bf16(dk * scale), _bf16(dv)


# (S, G, D, causal, window, kv_len): S 256 and 512, D 64, 128 and 160,
# causal, windowed, kv_len < S, non-causal, GQA groups 1 and 4; one KV head
EMU_CASES = [(256, 1, 64, True, 0, None), (256, 4, 128, True, 100, None),
             (512, 4, 128, True, 0, None), (512, 1, 64, False, 0, 300),
             (256, 4, 64, True, 0, 200), (512, 1, 128, True, 200, None),
             (256, 1, 128, False, 0, None), (512, 4, 64, True, 64, 400),
             (256, 4, 160, True, 0, None), (512, 1, 160, True, 100, 400),
             (256, 4, 160, False, 0, 200)]


@pytest.mark.parametrize("s,g,d,causal,window,kv_len", EMU_CASES)
def test_sm90_rounding_fits_the_bf16_tolerance(s, g, d, causal, window,
                                               kv_len):
    rng = np.random.default_rng(s + 10 * g + d)
    q, do = (_bf16(rng.standard_normal((g, s, d))) for _ in range(2))
    k, v = (_bf16(rng.standard_normal((1, s, d))) for _ in range(2))
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    o, m, l = jkernel.flash_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=64, bk=64,
        interpret=True, **kw)
    want = jkernel.flash_attention_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, m, l,
        jnp.asarray(do), bq=64, bk=64, interpret=True, **kw)
    got = _emulate_sm90(q, k, v, _bf16(np.asarray(o)), np.asarray(m),
                        np.asarray(l), do, causal=causal, window=window,
                        kv_len=s if kv_len is None else kv_len,
                        scale=d ** -0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b)
        err = float(np.abs(a - b).max())
        assert err <= BF16_REL * float(np.abs(b).max()) + 1e-6, (name, err)
    if kv_len is not None:
        assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


# the (S, G, causal, window, kv_len) of tests/test_torch_cuda.py's bf16
# backward rows
CARD_SHAPES = [(1, 4, True, 0, None), (1, 8, True, 0, None),
               (100, 1, True, 0, None), (257, 4, True, 100, None),
               (257, 8, True, 0, 200), (257, 1, False, 0, None),
               (1024, 4, True, 0, None), (1024, 8, True, 100, None),
               (1024, 1, False, 0, 700), (1024, 4, True, 0, 1000),
               (100, 4, True, 0, None)]


@pytest.mark.parametrize("s,g,causal,window,kv_len", CARD_SHAPES)
def test_expected_bwd_counts_match_jax_tiling(s, g, causal, window, kv_len):
    n = -(-s // 64) * 64
    kw = dict(bq=64, bk=64, causal=causal, window=window,
              kv_len=s if kv_len is None else kv_len)
    twin_q, twin_k = ops.expected_bwd_counts(s, g, causal=causal,
                                             window=window, kv_len=kv_len)
    assert twin_q == jtiling.kv_visits(n, **kw)
    assert twin_k == [g * c for c in jtiling.q_visits(n, **kw)]


def test_cpu_backward_stays_plain_for_every_route():
    """On the CPU every dtype combination, the sm90 one included, is the
    plain version: no kernel counter moves."""
    rng = np.random.default_rng(0)
    launches = lambda: [k.launches for k in (  # noqa: E731
        ops.BWD_DQ, ops.BWD_DKV, ops.BWD_DQ_SM90, ops.BWD_DKV_SM90)]
    before = launches()
    for rdt, gdt in ((BF, BF), (F32, F32), (BF, F32)):
        q, do = (torch.from_numpy(rng.standard_normal((2, 64, 64))
                                  .astype(np.float32)).to(t)
                 for t in (rdt, gdt))
        k, v = (torch.from_numpy(rng.standard_normal((1, 64, 64))
                                 .astype(np.float32)).to(rdt)
                for _ in range(2))
        o, m, l = ops.flash_attention_fwd(q, k, v)
        grads = ops.flash_attention_bwd(q, k, v, o, m, l, do,
                                        grad_dtypes=(gdt,) * 3)
        assert [t.dtype for t in grads] == [gdt] * 3
        assert all(torch.isfinite(t.float()).all() for t in grads)
    assert launches() == before
