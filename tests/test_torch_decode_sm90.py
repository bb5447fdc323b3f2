"""The Hopper split-K decode kernel (``kernels/csrc/flash_decode.cu``) on
the CPU: a numpy emulation of how it partitions and merges its work, held
against the JAX package's plain decode attention
(``repro.kernels.kvq.ref``), and its tile counters against
``tiling.decode_tile_step_counts``.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``,
``tests/test_torch_cuda_ssm.py``).  The emulation follows it step for step:
a unit is one (row, KV head, split, group of ``decode_heads_per_block``
query heads); a cluster of C CTAs of 4 warps shares the unit's live span,
each warp streaming its own run of 32-token blocks
(``tiling.decode_warp_blocks``), blocks that cross the bs tiles freely.
Each warp keeps its own online softmax in log2 units, moving its max only
when a score passes it by more than 8; the warps of a CTA merge in order,
then the CTAs of the cluster in rank order; one split normalises, more
write (acc, m, l) partials that ``combine_splits`` merges.  f32
throughout; the tolerance is the card's, 1e-5 against the plain version.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kvq import ref as jref
from repro_torch.kernels import tiling
from repro_torch.kernels.kvq import ops, ref

torch.set_num_threads(2)
F32 = np.float32
NEG_INF = F32(-1e30)
LOG2E, LN2 = F32(1.4426950408889634), F32(0.6931471805599453)
RESCALE_AT = F32(8.0)
TOL = 1e-5


def _inputs(b, hkv, g, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv, g, d)).astype(F32)
    kq, ks = ref.quantize_kv(torch.from_numpy(
        rng.standard_normal((b, hkv, s, d)).astype(F32)))
    vq, vs = ref.quantize_kv(torch.from_numpy(
        rng.standard_normal((b, hkv, s, d)).astype(F32)))
    return q, kq.numpy(), ks.numpy(), vq.numpy(), vs.numpy()


def _band(b, s, window, pos):
    """The window band of ``attention.decode_mask``: 0 on (pos - window,
    pos], -1e30 elsewhere."""
    kv = np.arange(s)
    row = np.where((kv <= pos) & (kv > pos - window), F32(0), NEG_INF)
    return np.broadcast_to(row.astype(F32), (b, s)).copy()


def _merge(states):
    """(acc, m, l) states merged in order, in log2 units."""
    mx = np.max(np.stack([st[1] for st in states]), axis=0)
    acc = np.zeros_like(states[0][0])
    l = np.zeros_like(states[0][2])
    for a, m, ll in states:
        w = np.exp2(m - mx).astype(F32)
        acc = acc + a * w[:, None]
        l = l + ll * w
    return acc.astype(F32), mx.astype(F32), l.astype(F32)


def emulate(q, kq, ks, vq, vs, *, lengths=None, bias=None, splits=1,
            cluster=1, block_s=tiling.DEFAULT_DECODE_BS):
    """The kernel's partition and arithmetic.  Returns (out (B, Hkv, G, D),
    the bs tiles each (b, h, split) touched, what the run saw: the dead
    warp / CTA / split slices and the largest p)."""
    b_, hkv, g_, d = q.shape
    s = kq.shape[2]
    bs, ns, nsp, spt = tiling.resolve_decode_grid(s, block_s=block_s,
                                                  splits=splits)
    gh = tiling.decode_heads_per_block(g_)
    tb, nw = tiling.DECODE_TOKENS, tiling.DECODE_WARPS
    sc2 = F32(d ** -0.5)
    part_acc = np.zeros((b_, hkv, nsp, g_, d), F32)
    part_m = np.full((b_, hkv, nsp, g_), NEG_INF, F32)
    part_l = np.zeros((b_, hkv, nsp, g_), F32)
    touched = np.zeros((b_, hkv, nsp), np.int64)
    seen = {"dead_warp": 0, "dead_cta": 0, "dead_split": 0, "p_max": 0.0}
    for b in range(b_):
        ln = s if bias is not None else int(lengths[b])
        for h in range(hkv):
            kf = kq[b, h].astype(F32)
            vf = vq[b, h].astype(F32)
            for sp in range(nsp):
                tlo, thi = sp * spt, min(sp * spt + spt, ns)
                lo, e = tlo * bs, min(thi * bs, ln)
                runs = tiling.decode_warp_blocks(e - lo, cluster)
                tiles = set()
                for hg in range(g_ // gh):
                    heads = slice(hg * gh, hg * gh + gh)
                    qh = q[b, h, heads]
                    ctas, split_dead = [], True
                    for rank in range(cluster):
                        warps, cta_dead = [], True
                        for w in range(nw):
                            blk0, blk1 = runs[rank * nw + w]
                            acc = np.zeros((gh, d), F32)
                            m = np.full(gh, NEG_INF, F32)
                            l = np.zeros(gh, F32)
                            warp_dead = True
                            for i in range(blk0, blk1):
                                t = np.arange(lo + i * tb,
                                              min(lo + i * tb + tb, e))
                                tiles.update(int(x) // bs for x in t)
                                sb = (bias[b, t] if bias is not None
                                      else np.zeros(len(t), F32))
                                warp_dead &= bool((sb <= NEG_INF).all())
                                part = (qh @ kf[t].T).astype(F32)
                                s2 = ((part * ks[b, h, t] * sc2 + sb)
                                      * LOG2E).astype(F32)
                                if (s2 > (m + RESCALE_AT)[:, None]).any():
                                    mn = np.maximum(m, s2.max(axis=1))
                                    alpha = np.exp2(m - mn).astype(F32)
                                    l, acc, m = l * alpha, \
                                        acc * alpha[:, None], mn
                                p = np.exp2(s2 - m[:, None]).astype(F32)
                                seen["p_max"] = max(seen["p_max"],
                                                    float(p.max()))
                                l = (l + p.sum(axis=1)).astype(F32)
                                acc = (acc + (p * vs[b, h, t]) @ vf[t]) \
                                    .astype(F32)
                            if blk1 > blk0:
                                seen["dead_warp"] += warp_dead
                                cta_dead &= warp_dead
                            warps.append((acc, m, l))
                        if any(r[1] > r[0] for r in
                               runs[rank * nw:(rank + 1) * nw]):
                            seen["dead_cta"] += cta_dead
                            split_dead &= cta_dead
                        ctas.append(_merge(warps))
                    if e > lo:
                        seen["dead_split"] += split_dead
                    acc, m, l = _merge(ctas)
                    part_acc[b, h, sp, heads] = acc
                    part_m[b, h, sp, heads] = m * LN2
                    part_l[b, h, sp, heads] = l
                touched[b, h, sp] = len(tiles)
    if nsp == 1:
        out = part_acc[:, :, 0] / np.maximum(part_l[:, :, 0], F32(1e-30))[
            ..., None]
    else:
        out = ref.combine_splits(*(torch.from_numpy(x) for x in (
            part_acc, part_m, part_l)), torch.float32).numpy()
    return out.astype(F32), touched, seen


def _jax_out(q, kq, ks, vq, vs, *, lengths=None, bias=None):
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    out = jref.decode_attention_ref(
        j(q), j(kq), j(ks), j(vq), j(vs), j(bias), q.shape[-1] ** -0.5,
        lengths=j(lengths))
    return np.asarray(out)


def _lengths(s, b):
    """Ragged lengths with 1, bs - 1, bs + 1 and the full cache."""
    bs = tiling.resolve_decode_block(s, tiling.DEFAULT_DECODE_BS)
    pick = [1, bs - 1, bs + 1, s, s // 2 + 7, 33]
    return np.array([pick[i % len(pick)] for i in range(b)], np.int32)


# (S, G, D, splits, cluster): both caches (S = 2048 in 512-token tiles,
# S = 2080 in 32-token tiles), every G the kernel takes, splits 1-4, and
# clusters from one CTA to eight
LENGTH_CASES = [
    (2048, 1, 64, 1, 1), (2048, 1, 128, 4, 8), (2048, 4, 128, 1, 8),
    (2048, 4, 128, 4, 1), (2048, 4, 64, 2, 3), (2048, 5, 64, 1, 5),
    (2048, 5, 128, 3, 2), (2048, 8, 128, 1, 4), (2048, 8, 64, 4, 8),
    (2048, 3, 128, 2, 1), (2048, 6, 64, 1, 6), (2048, 16, 64, 1, 2),
    (2080, 1, 128, 1, 8), (2080, 4, 128, 2, 5), (2080, 4, 64, 4, 1),
    (2080, 5, 64, 1, 5), (2080, 5, 64, 4, 2), (2080, 5, 128, 3, 8),
    (2080, 8, 64, 1, 3), (2080, 8, 128, 2, 4), (2080, 3, 64, 4, 7),
    (2080, 6, 128, 1, 1), (2080, 16, 128, 1, 8), (2080, 2, 64, 2, 4),
    # head_dim 160 (stablelm-12b, G 4): 8 lanes a K row, 16 a V row
    (2048, 4, 160, 4, 8), (2048, 4, 160, 1, 3), (2080, 4, 160, 2, 5),
    (2080, 1, 160, 1, 8), (2048, 8, 160, 3, 2),
]


@pytest.mark.parametrize("s,g,d,splits,cluster", LENGTH_CASES)
def test_emulation_matches_jax_lengths(s, g, d, splits, cluster):
    b, hkv = 6, 1
    q, kq, ks, vq, vs = _inputs(b, hkv, g, s, d, seed=s + 10 * g + splits)
    lengths = _lengths(s, b)
    out, touched, seen = emulate(q, kq, ks, vq, vs, lengths=lengths,
                                 splits=splits, cluster=cluster)
    want = _jax_out(q, kq, ks, vq, vs, lengths=lengths)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, want, atol=TOL, rtol=0)
    twin = tiling.decode_tile_step_counts(s, lengths.tolist(),
                                          splits=splits)
    assert touched.tolist() == [[row] * hkv for row in twin["counts"]]
    assert seen["p_max"] <= 2.0 ** 8


# (S, G, D, splits, cluster, window, pos): bands narrow enough that whole
# warp, CTA and split slices see only -1e30
BIAS_CASES = [
    (2080, 5, 64, 1, 8, 100, 2050), (2080, 5, 64, 2, 8, 100, 2050),
    (2080, 5, 64, 4, 2, 1024, 2078), (2080, 4, 128, 1, 5, 40, 10),
    (2080, 1, 64, 3, 4, 300, 1500), (2048, 8, 128, 4, 2, 64, 1000),
    (2048, 4, 64, 1, 8, 200, 2047), (2048, 5, 128, 2, 3, 33, 512),
    (2080, 16, 64, 1, 8, 64, 700), (2080, 6, 128, 4, 1, 500, 2079),
    (2080, 4, 160, 4, 2, 500, 2079), (2048, 4, 160, 1, 8, 64, 1000),
]


@pytest.mark.parametrize("s,g,d,splits,cluster,window,pos", BIAS_CASES)
def test_emulation_matches_jax_band(s, g, d, splits, cluster, window, pos):
    b, hkv = 2, 2
    q, kq, ks, vq, vs = _inputs(b, hkv, g, s, d, seed=window + pos)
    bias = _band(b, s, window, pos)
    out, touched, seen = emulate(q, kq, ks, vq, vs, bias=bias,
                                 splits=splits, cluster=cluster)
    want = _jax_out(q, kq, ks, vq, vs, bias=bias)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, want, atol=TOL, rtol=0)
    # every tile of every split is visited, as on the TPU
    twin = tiling.decode_tile_step_counts(s, None, splits=splits)
    assert touched.tolist() == [[twin["counts"][0]] * hkv] * b
    # the band leaves whole slices at -1e30 (they drop out with weight 0)
    assert seen["dead_warp"] > 0
    if cluster > 1:
        assert seen["dead_cta"] > 0
    if splits > 1 and window < s // splits:
        assert seen["dead_split"] > 0


@pytest.mark.parametrize("s,lengths,splits,block_s", [
    (2048, [1, 511, 512, 513, 2048, 0], 4, 512),
    (2080, [1, 31, 32, 33, 2079, 2080], 1, 512),
    (2080, [1, 31, 33, 1040, 2080], 4, 512),
    (1024, [1, 255, 257, 1024], 3, 256),
    (640, [1, 127, 129, 640], 2, 128),
])
def test_counts_equal_tiling_twin(s, lengths, splits, block_s):
    q, kq, ks, vq, vs = _inputs(len(lengths), 1, 1, s, 64, seed=s)
    lens = np.array(lengths, np.int32)
    for cluster in (1, 3, 8):
        _, touched, _ = emulate(q, kq, ks, vq, vs, lengths=lens,
                                splits=splits, cluster=cluster,
                                block_s=block_s)
        twin = tiling.decode_tile_step_counts(s, lengths, block_s=block_s,
                                              splits=splits)
        assert touched[:, 0].tolist() == twin["counts"]


@pytest.mark.parametrize("n_live", [0, 1, 31, 32, 33, 100, 512, 2080])
def test_warp_runs_cover_the_span_once(n_live):
    nbt = -(-n_live // tiling.DECODE_TOKENS)
    for cluster in range(1, tiling.DECODE_MAX_CLUSTER + 1):
        runs = tiling.decode_warp_blocks(n_live, cluster)
        assert len(runs) == cluster * tiling.DECODE_WARPS
        assert runs[0][0] == 0 and runs[-1][1] == nbt
        assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
        sizes = [hi - lo for lo, hi in runs]
        assert max(sizes) - min(sizes) <= 1


def test_groups_and_heads_per_block():
    # the kernel's dispatch: G -> the heads a CTA keeps in registers
    want = {1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 3, 8: 4, 16: 4}
    assert set(ops.SUPPORTED_GROUPS) == set(want)
    for g, gh in want.items():
        assert tiling.decode_heads_per_block(g) == gh
        assert gh <= tiling.DECODE_MAX_HEADS and g % gh == 0


def test_int8_to_f32_by_byte_permute():
    # the kernel's conversion: (b ^ 0x80) in the low byte of 0x4B000000 is
    # the float 2^23 + 128 + b; minus 2^23 + 128 it is b, exactly
    b = np.arange(-128, 128, dtype=np.int32)
    bits = (0x4B000000 | ((b & 0xFF) ^ 0x80)).astype(np.uint32)
    f = bits.view(F32) - F32(8388736.0)
    assert f.dtype == F32 and np.array_equal(f, b.astype(F32))
