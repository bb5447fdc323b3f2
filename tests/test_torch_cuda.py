"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``cuda``: without a CUDA device (and nvcc) every test
here skips; on the H100 run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import tiling
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as flash_ref
from repro_torch.kernels.kvq import ops as kvq_ops
from repro_torch.kernels.kvq import ref as kvq_ref
from repro_torch.models import attention

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


F32, BF = torch.float32, torch.bfloat16
# (S, G, D, causal, window, kv_len, dtype): ragged S, GQA, windows,
# kv_len < S, non-causal.  The bf16 rows at D 64 / 128 / 160 go to
# flash_fwd_sm90.cu, the others to flash_fwd.cu.
FWD_CASES = [
    (1, 4, 128, True, 0, None, F32), (63, 1, 64, True, 0, None, F32),
    (65, 2, 128, True, 16, None, F32), (200, 8, 64, True, 0, None, F32),
    (257, 4, 128, True, 100, None, F32), (40, 2, 16, True, 0, None, F32),
    (1, 4, 128, True, 0, None, BF), (1, 8, 64, True, 0, None, BF),
    (63, 1, 64, True, 0, None, BF), (65, 8, 128, True, 16, None, BF),
    (100, 4, 64, False, 0, 70, BF), (100, 1, 128, True, 0, None, BF),
    (257, 1, 128, True, 100, None, BF), (257, 8, 64, True, 0, 200, BF),
    (257, 4, 128, False, 0, None, BF), (1024, 4, 128, True, 0, None, BF),
    (1024, 8, 64, True, 1000, None, BF), (1024, 1, 128, False, 0, 700, BF),
    (40, 2, 16, True, 0, None, BF),
    # head_dim 160 (stablelm-12b): three panels, Q in registers
    (1, 4, 160, True, 0, None, BF), (100, 4, 160, True, 0, None, BF),
    (257, 1, 160, True, 100, 200, BF), (1024, 4, 160, True, 0, None, BF),
    (65, 2, 160, True, 16, None, F32), (257, 4, 160, False, 0, 200, F32),
    # whisper-base's decoder: G = 1 at head_dim 64, its 448-token context
    # (7 query tiles of 64, the last 128-row block ragged)
    (448, 1, 64, True, 0, None, BF), (448, 1, 64, True, 0, 300, BF),
]
# launch counters of the two forward designs
FWD_KERNELS = {"fma": flash_ops.KERNEL, "sm90": flash_ops.FWD_SM90}


@pytest.mark.parametrize("s,g,d,causal,window,kv_len,dtype", FWD_CASES)
def test_flash_kernel_matches_plain(dev, s, g, d, causal, window, kv_len,
                                    dtype):
    gen = torch.Generator(device=dev).manual_seed(s)
    hkv = 2
    q, k, v = (torch.randn((n, s, d), generator=gen, device=dev).to(dtype)
               for n in (hkv * g, hkv, hkv))
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    before = {r: kern.launches for r, kern in FWD_KERNELS.items()}
    o, m, l, cnt = flash_ops.flash_attention_fwd(q, k, v, counts=True, **kw)
    route = flash_ops.fwd_route(dtype, d)
    assert {r: kern.launches - before[r] for r, kern in FWD_KERNELS.items()} \
        == {r: int(r == route) for r in FWD_KERNELS}
    o_r, m_r, l_r = flash_ref.flash_fwd_ref(q, k, v, **kw)
    # f32: summation order only.  bf16: kernel and plain each round o once
    # to bf16 (|o| < 4: one ulp <= 0.0156), and the sm90 kernel rounds P
    # to bf16 before P V
    tol, stat_tol = (1e-4, 1e-4) if dtype == F32 else (2e-2, 1e-3)
    assert o.dtype == dtype
    torch.testing.assert_close(o.float(), o_r.float(), atol=tol, rtol=0)
    torch.testing.assert_close(m, m_r, atol=stat_tol, rtol=0)
    torch.testing.assert_close(l, l_r, rtol=stat_tol, atol=0)
    assert cnt.tolist() == [flash_ops.expected_counts(s, **kw)] * (hkv * g)


@pytest.mark.parametrize("dtype,d", [(F32, 64), (BF, 64), (BF, 128),
                                     (BF, 160), (F32, 160)])
def test_flash_rows_with_no_live_key_write_zeros(dev, dtype, d):
    """kv_len = 0, non-causal: each design runs no KV tile and writes
    o = 0, m = -1e30, l = 0 (the plain version's softmax over an all-masked
    row is uniform instead, so it is no reference here)."""
    gen = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (torch.randn((n, 70, d), generator=gen, device=dev).to(dtype)
               for n in (4, 2, 2))
    kern = FWD_KERNELS[flash_ops.fwd_route(dtype, d)]
    before = kern.launches
    o, m, l, cnt = flash_ops.flash_attention_fwd(q, k, v, causal=False,
                                                 kv_len=0, counts=True)
    assert kern.launches == before + 1
    assert not o.any() and not l.any() and bool((m == -1e30).all())
    assert not cnt.any()


def _close(got, want, rel, floor=1e-6):
    """max |got - want| <= rel * max |want| + floor, compared in f32.  The
    floor covers gradients that cancel to ~0 (S = 1: dQ is f32 noise)."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * scale + floor, (err, rel * scale + floor)


# (S, G, D, causal, window, kv_len, residual dtype, dO dtype): ragged S,
# GQA, windows, kv_len < S, and the three dtype combinations of the
# policies (f32; bf16; bf16 residuals under f32 compute).  The all-bf16
# rows at D 64 / 128 / 160 go to flash_bwd_sm90.cu, the others to
# flash_bwd.cu.
BWD_CASES = [
    (1, 4, 128, True, 0, None, torch.float32, torch.float32),
    (100, 4, 128, True, 0, None, torch.bfloat16, torch.bfloat16),
    (130, 2, 64, True, 0, None, torch.float32, torch.float32),
    (300, 1, 128, True, 100, None, torch.float32, torch.float32),
    (200, 8, 64, False, 0, 137, torch.float32, torch.float32),
    (257, 4, 128, True, 0, 200, torch.float32, torch.float32),
    (192, 4, 128, True, 0, None, torch.bfloat16, torch.float32),
    (70, 2, 16, True, 0, None, torch.float32, torch.float32),
    (1, 4, 128, True, 0, None, BF, BF),
    (1, 8, 64, True, 0, None, BF, BF),
    (100, 1, 64, True, 0, None, BF, BF),
    (257, 4, 128, True, 100, None, BF, BF),
    (257, 8, 64, True, 0, 200, BF, BF),
    (257, 1, 128, False, 0, None, BF, BF),
    (1024, 4, 128, True, 0, None, BF, BF),
    (1024, 8, 64, True, 100, None, BF, BF),
    (1024, 1, 128, False, 0, 700, BF, BF),
    (1024, 4, 64, True, 0, 1000, BF, BF),
    (70, 2, 16, True, 0, None, BF, BF),
    # head_dim 160 (stablelm-12b): dQ one block an SM, dKV two warpgroups
    # (S = 3, not 1: at S = 1 dQ is only the cancellation of dP - delta,
    # whose rounding noise grows with D past the floor; D = 128 keeps S = 1)
    (3, 4, 160, True, 0, None, BF, BF), (100, 4, 160, True, 0, None, BF, BF),
    (257, 2, 160, True, 100, 200, BF, BF),
    (1024, 4, 160, True, 0, None, BF, BF),
    (257, 1, 160, False, 0, None, BF, BF),
    (130, 4, 160, True, 0, None, torch.float32, torch.float32),
    (192, 4, 160, True, 0, None, torch.bfloat16, torch.float32),
    # whisper-base's decoder: G = 1 at head_dim 64, S 448
    (448, 1, 64, True, 0, None, BF, BF),
    (448, 1, 64, True, 0, None, torch.float32, torch.float32),
]
# launch counters of the two dQ / dKV designs
BWD_KERNELS = {"fma": (flash_ops.BWD_DQ, flash_ops.BWD_DKV),
               "sm90": (flash_ops.BWD_DQ_SM90, flash_ops.BWD_DKV_SM90)}


def _launches():
    return {r: [k.launches for k in ks] for r, ks in BWD_KERNELS.items()}


def _assert_route(before, route):
    """One dQ and one dKV launch of ``route``'s kernels, none of the
    other's."""
    after = _launches()
    for r in BWD_KERNELS:
        want = 1 if r == route else 0
        assert [a - b for a, b in zip(after[r], before[r])] == [want] * 2, r


@pytest.mark.parametrize("s,g,d,causal,window,kv_len,rdt,gdt", BWD_CASES)
def test_flash_bwd_kernels_match_plain(dev, s, g, d, causal, window, kv_len,
                                       rdt, gdt):
    gen = torch.Generator(device=dev).manual_seed(s + g)
    hkv = 2
    q, k, v = (torch.randn((n, s, d), generator=gen, device=dev).to(rdt)
               for n in (hkv * g, hkv, hkv))
    o, m, l = flash_ops.flash_attention_fwd(q, k, v, causal=causal,
                                            window=window, kv_len=kv_len)
    do = torch.randn((hkv * g, s, d), generator=gen, device=dev).to(gdt)
    grad_dt = (gdt,) * 3
    kw = dict(causal=causal, window=window, kv_len=kv_len,
              grad_dtypes=grad_dt)
    before = _launches()
    dq, dk, dv, cq, ck = flash_ops.flash_attention_bwd(q, k, v, o, m, l, do,
                                                       counts=True, **kw)
    _assert_route(before, flash_ops.bwd_route(rdt, gdt, gdt, d))
    want = flash_ref.flash_bwd_ref(q, k, v, o, m, l, do, **kw)
    # f32: summation order only; bf16 grads: one rounding of each output
    rel = 1e-4 if gdt == torch.float32 else 2e-2
    for got, ref_ in zip((dq, dk, dv), want):
        assert got.dtype == gdt
        _close(got, ref_, rel)
    if kv_len is not None:              # keys past kv_len get exact zeros
        assert not dk[:, kv_len:].any() and not dv[:, kv_len:].any()
    twin_q, twin_k = flash_ops.expected_bwd_counts(
        s, g, causal=causal, window=window, kv_len=kv_len)
    assert cq.tolist() == [twin_q] * (hkv * g)
    assert ck.tolist() == [twin_k] * hkv


@pytest.mark.parametrize("resid", [None, torch.bfloat16])
def test_flash_attention_grads_card_vs_cpu(dev, resid):
    gen = torch.Generator().manual_seed(7)
    b, h, hkv, s, d = 2, 4, 2, 150, 64
    cpu = [torch.randn(shape, generator=gen, requires_grad=True)
           for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]
    card = [x.detach().to(dev).requires_grad_() for x in cpu]
    w = torch.randn((b, h, s, d), generator=gen)
    for xs, wt in ((cpu, w), (card, w.to(dev))):
        out = flash_ops.flash_attention(*xs, window=0, resid_dtype=resid)
        (out * wt).sum().backward()
    rel = 1e-4 if resid is None else 2e-2
    for a, b_ in zip(card, cpu):
        assert a.grad.dtype == torch.float32
        _close(a.grad.cpu(), b_.grad, rel)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bf16_grads_card_vs_cpu(dev, d):
    """bf16 inputs: the card's backward is the tensor-core kernels, the
    CPU's the plain version; both write bf16 gradients from f32 sums."""
    gen = torch.Generator().manual_seed(d)
    b, h, hkv, s = 2, 4, 2, 150
    cpu = [torch.randn(shape, generator=gen).to(BF).requires_grad_()
           for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]
    card = [x.detach().to(dev).requires_grad_() for x in cpu]
    w = torch.randn((b, h, s, d), generator=gen).to(BF)
    before = _launches()
    for xs, wt in ((cpu, w), (card, w.to(dev))):
        out = flash_ops.flash_attention(*xs, window=0)
        (out.float() * wt.float()).sum().backward()
    _assert_route(before, "sm90")
    for a, b_ in zip(card, cpu):
        assert a.grad.dtype == BF
        _close(a.grad.cpu(), b_.grad, 2e-2)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_decode_kernel_matches_plain(dev, splits):
    b, hkv, g, d, s = 4, 2, 4, 128, 1024
    gen = torch.Generator(device=dev).manual_seed(splits)
    q = torch.randn((b, hkv * g, d), generator=gen, device=dev)
    kq, ks = kvq_ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=dev))
    vq, vs = kvq_ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=dev))
    lens = [1, 1024, 300, 513]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    out, cnt = kvq_ops.decode_attention(q, kq, ks, vq, vs, lengths=lengths,
                                        splits=splits, block_s=256,
                                        counts=True)
    want = kvq_ref.decode_attention_splitk_ref(
        q.reshape(b, hkv, g, d), kq, ks, vq, vs, d ** -0.5, lengths=lengths,
        block_s=256, splits=splits).reshape(b, hkv * g, d)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    twin = tiling.decode_tile_step_counts(s, lens, block_s=256,
                                          splits=splits)
    assert cnt.tolist() == [[row] * hkv for row in twin["counts"]]


# (B, Hkv, G, D, S, lengths, splits): one or two (row, KV head) units, so
# the kernel runs clusters of up to 8 CTAs over each split's span and
# merges them through distributed shared memory; ragged lengths leave
# whole warps and CTAs with no live token; G 3, 6, 16 (head groups of
# 3, 3, 4 CTAs apart) and 8
DECODE_FILL_CASES = [
    (1, 1, 4, 128, 2048, [2048], 1), (1, 1, 4, 128, 2048, [33], 1),
    (2, 1, 5, 64, 2080, [2079, 1], 1), (2, 1, 4, 128, 2048, [1, 1500], 4),
    (1, 1, 1, 64, 4096, [4096], 2), (2, 2, 3, 128, 512, [1, 300], 1),
    (2, 2, 6, 64, 512, [511, 33], 2), (1, 2, 16, 128, 1024, [1000], 1),
    (2, 2, 8, 64, 1024, [1024, 65], 3),
    # head_dim 160: 8 lanes a K row at 20 bytes, 16 a V row at 10
    (2, 2, 4, 160, 2048, [2048, 33], 1), (1, 8, 4, 160, 2048, [1500], 4),
    (2, 1, 1, 160, 2080, [2079, 1], 2), (2, 1, 5, 160, 2080, [2079, 1], 1),
]


@pytest.mark.parametrize("b,hkv,g,d,s,lens,splits", DECODE_FILL_CASES)
def test_decode_kernel_fills_card(dev, b, hkv, g, d, s, lens, splits):
    gen = torch.Generator(device=dev).manual_seed(s + g)
    q = torch.randn((b, hkv * g, d), generator=gen, device=dev)
    kq, ks = kvq_ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=dev))
    vq, vs = kvq_ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=dev))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    out, cnt = kvq_ops.decode_attention(q, kq, ks, vq, vs, lengths=lengths,
                                        splits=splits, counts=True)
    want = kvq_ref.decode_attention_ref(
        q.reshape(b, hkv, g, d), kq, ks, vq, vs, None, d ** -0.5,
        lengths=lengths).reshape(b, hkv * g, d)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    twin = tiling.decode_tile_step_counts(s, lens, splits=splits)
    assert cnt.tolist() == [[row] * hkv for row in twin["counts"]]


# whisper-base's decode (G = 1, D = 64: launch<1, 64>) and qwen2-vl-2b's
# (G = 6, D = 128: launch<3, 128>, two head groups of CTAs)
ENCDEC_VLM_DECODE = [
    (4, 8, 1, 64, 512, [1, 512, 300, 64], 1),
    (4, 8, 1, 64, 512, [1, 512, 300, 64], 4),
    (3, 2, 6, 128, 2048, [2048, 1, 1500], 4),
    (3, 2, 6, 128, 2048, [2048, 1, 1500], 1),
]


@pytest.mark.parametrize("b,hkv,g,d,s,lens,splits", ENCDEC_VLM_DECODE)
def test_decode_kernel_at_encdec_vlm_groups(dev, b, hkv, g, d, s, lens,
                                            splits):
    """The lengths entry at the two archs' groups against its plain
    version; one launch of it and none of the dense-bias entry."""
    before = (kvq_ops.KERNEL.launches, kvq_ops.BIAS_KERNEL.launches)
    test_decode_kernel_fills_card(dev, b, hkv, g, d, s, lens, splits)
    assert (kvq_ops.KERNEL.launches - before[0],
            kvq_ops.BIAS_KERNEL.launches - before[1]) == (1, 0)


@pytest.mark.parametrize("window,pos,splits", [
    (100, 2050, 1), (100, 2050, 2), (40, 10, 1), (1024, 2078, 4)])
def test_decode_bias_band_leaves_dead_ctas(dev, window, pos, splits):
    # one row, two KV heads: clusters of 8 CTAs split the 2080 slots, so a
    # narrow band leaves whole CTA (and split) slices at -1e30
    b, hkv, g, d, s = 1, 2, 5, 64, 2080
    gen = torch.Generator(device=dev).manual_seed(window + pos)
    q = torch.randn((b, hkv * g, d), generator=gen, device=dev)
    kq, ks = kvq_ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=dev))
    vq, vs = kvq_ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=dev))
    _, bias = attention.decode_mask(
        torch.tensor(pos, dtype=torch.int32, device=dev), b, s, window)
    out, cnt = kvq_ops.decode_attention(q, kq, ks, vq, vs, bias=bias,
                                        splits=splits, counts=True)
    want = kvq_ref.decode_attention_ref(
        q.reshape(b, hkv, g, d), kq, ks, vq, vs, bias,
        d ** -0.5).reshape(b, hkv * g, d)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    twin = tiling.decode_tile_step_counts(s, None, splits=splits)
    assert cnt.tolist() == [[twin["counts"][0]] * hkv]


@pytest.mark.parametrize("seed", range(4))
def test_decode_bias_band_at_head_dim_160(dev, seed):
    """stablelm-12b's decode heads (8 KV heads, G=4, D=160) on a band of
    1024 at the last slot of 2080, one split: whole warps see only
    -1e30 while others move their max, so every accumulator column must
    be rescaled."""
    b, hkv, g, d, s = 8, 8, 4, 160, 2080
    gen = torch.Generator(device=dev).manual_seed(51 + seed)
    q = torch.randn((b, hkv * g, d), generator=gen, device=dev)
    kq, ks = kvq_ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=dev))
    vq, vs = kvq_ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=dev))
    _, bias = attention.decode_mask(
        torch.tensor(s - 2, dtype=torch.int32, device=dev), b, s, 1024)
    out = kvq_ops.decode_attention(q, kq, ks, vq, vs, bias=bias)
    want = kvq_ref.decode_attention_ref(
        q.reshape(b, hkv, g, d), kq, ks, vq, vs, bias,
        d ** -0.5).reshape(b, hkv * g, d)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("bias", [False, True])
def test_decode_partials_form(dev, splits, bias):
    """``partials=True``: the kernel's unnormalised (o, m, l) divide out
    to the normalised output of the same call at one and at several
    splits and to the plain partials', their log-sum-exp ``m + log l``
    is the plain one's (the kernel's running max is not the row max: it
    moves only past a margin), and a row with no live position (length
    0: no tile read) gives (0, NEG_INF, 0) exactly; the cross-shard merge
    of 2 shards equals the unsharded kernel."""
    from repro_torch.distributed.collectives import merge_partials
    b, hkv, g, d, s = 4, 2, 4, 128, 1024
    gen = torch.Generator(device=dev).manual_seed(7 + splits)
    q = torch.randn((b, hkv * g, d), generator=gen, device=dev)
    kq, ks = kvq_ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=dev))
    vq, vs = kvq_ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=dev))
    lens = torch.tensor([0, 1024, 300, 513], dtype=torch.int32, device=dev)
    if bias:
        kpos = torch.arange(s, device=dev)
        mask = dict(bias=torch.where(kpos[None] < lens[:, None], 0.0,
                                     tiling.NEG_INF).float().contiguous())
    else:
        mask = dict(lengths=lens)
    before = kvq_ops.BIAS_KERNEL.launches if bias else kvq_ops.KERNEL.launches
    o, m, l = kvq_ops.decode_attention(q, kq, ks, vq, vs, splits=splits,
                                       partials=True, **mask)
    after = kvq_ops.BIAS_KERNEL.launches if bias else kvq_ops.KERNEL.launches
    assert after - before == 1
    # the plain partials on the card, as the other decode tests compare
    po, pm, pl = (t.reshape(b, hkv * g, *t.shape[3:]) for t in
                  kvq_ref.decode_partials_ref(
                      q.reshape(b, hkv, g, d), kq, ks, vq, vs,
                      mask.get("bias"), d ** -0.5,
                      lengths=mask.get("lengths")))
    live = slice(1, None)                  # row 0 has no live position
    norm = o[live] / l[live][..., None]
    want = kvq_ops.decode_attention(q, kq, ks, vq, vs, splits=splits,
                                    **mask)
    torch.testing.assert_close(norm, want[live], atol=1e-5, rtol=0)
    torch.testing.assert_close(norm, (po / pl[..., None])[live], atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(m[live] + l[live].log(),
                               pm[live] + pl[live].log(), atol=1e-5,
                               rtol=1e-6)
    if not bias:                  # a bias row of -1e30 is live to the kernel
        assert torch.all(m[0] == tiling.NEG_INF)
        assert torch.all(l[0] == 0) and torch.all(o[0] == 0)
    # two sequence shards merged across, lengths form: the unsharded call
    if not bias:
        half = s // 2
        parts = [kvq_ops.decode_attention(
            q, *(c[:, :, r * half:(r + 1) * half].contiguous()
                 for c in (kq, ks, vq, vs)), splits=splits, partials=True,
            lengths=torch.clamp(lens - r * half, 0, half).to(torch.int32))
            for r in range(2)]
        got = merge_partials(*(torch.stack(t) for t in zip(*parts)))
        torch.testing.assert_close(got[live], want[live], atol=1e-5, rtol=0)


def test_unsupported_shapes_raise(dev):
    x = torch.zeros((2, 8, 32), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention_fwd(x, x, x)
    # the tensor-core forward loads q, k, v by TMA: 16-byte aligned only
    base = torch.zeros(2 * 64 * 64 + 1, dtype=BF, device=dev)
    off = base[1:].view(2, 64, 64)
    with pytest.raises(ValueError, match="aligned"):
        flash_ops.flash_attention_fwd(off, off, off)
    q = torch.zeros((1, 14, 64), device=dev)     # G = 7
    cache = torch.zeros((1, 2, 64, 64), dtype=torch.int8, device=dev)
    scales = torch.ones((1, 2, 64), device=dev)
    with pytest.raises(ValueError, match="group"):
        kvq_ops.decode_attention(q, cache, scales, cache, scales)


def test_engine_goes_through_both_kernels(dev):
    from repro_torch.models import transformer
    from repro_torch.serve import (ServeEngine, kernel_launches,
                                   synthetic_trace)
    cfg = dataclasses.replace(configs.smoke_config("llama3-8b"),
                              d_model=256, n_heads=4, n_kv=2, head_dim=64)
    eng = ServeEngine(transformer.init_params(cfg, 0, device=dev), cfg,
                      max_slots=4, max_len=128, policy_name="full",
                      kv_splits=2)
    eng.warmup()
    before = kernel_launches()
    summ = eng.run(synthetic_trace(6, seed=0, vocab=cfg.vocab,
                                   max_prompt=48, max_gen=32))
    after = kernel_launches()
    diag = summ["diagnostics"]
    assert summ["n_done"] == 6 and summ["n_faults"] == 0
    assert after["flash_fwd"] - before["flash_fwd"] == \
        cfg.n_layers * diag["prefills"]
    assert after["flash_decode"] - before["flash_decode"] == \
        cfg.n_layers * diag["decode_rounds"]


@pytest.mark.parametrize("remat", [
    {"policy": "dots"}, {"policy": "dots_nobatch"},
    {"save_names": ("attn_out", "ffn_out")}, {"policy": "full"}])
def test_selective_remat_relaunches_flash_on_card(dev, remat):
    """Under every remat policy the flash forward is recomputed, kernel
    launch included (no policy caches what is inside the op), and the
    loss and gradients equal remat off's on the card."""
    from repro_torch.core.checkpoint import CheckpointConfig
    from repro_torch.core.mixed_precision import Policy
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(configs.get_config("llama3-8b"), n_layers=2,
                              d_model=512, n_heads=4, n_kv=1, d_ff=1024,
                              vocab=1000, head_dim=128)
    model = tf.init_params(cfg, 0, device=dev).requires_grad_()
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 100), generator=gen, device=dev)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    params = [p for p in model.parameters()]

    def run(config):
        flash_ops.FWD_SM90.launches = 0
        loss, _ = tf.loss_fn(model, cfg, batch, policy=Policy.bf16(),
                             remat=config)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return loss, grads, flash_ops.FWD_SM90.launches

    loss0, grads0, n0 = run(CheckpointConfig(enabled=False))
    loss, grads, n = run(CheckpointConfig(**remat))
    assert n0 == cfg.n_layers and n == 2 * cfg.n_layers
    assert float(loss) == float(loss0)
    for g, g0 in zip(grads, grads0):       # the same arithmetic, rerun
        assert float((g - g0).abs().max()) <= 1e-6 * float(g0.abs().max())


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_ce_backward_on_card(dev, n, monkeypatch):
    """``transformer._VocabParallelCE`` on CUDA blocks, one process: the
    group's three reductions (row max, sum of exp, label logit) done by
    hand over every block, each block's NLL and logits' gradient against
    ``_ce_terms`` on the whole logits under autograd (vocab 250, its dead
    tail in the last block)."""
    from repro_torch.distributed import collectives
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(configs.smoke_config("llama3-8b"), vocab=250)
    gen = torch.Generator(device=dev).manual_seed(2)
    whole = torch.randn(2, 33, cfg.padded_vocab, generator=gen,
                        device=dev) * 3
    labels = torch.randint(0, cfg.vocab, (2, 33), generator=gen, device=dev)
    upstream = torch.rand(2, 33, generator=gen, device=dev) + 0.5
    masked = tf._mask_padded_vocab(whole, cfg)
    ref = whole.clone().requires_grad_()
    nll = tf._ce_terms(tf._mask_padded_vocab(ref, cfg), labels)
    (nll * upstream).sum().backward()
    v_l = cfg.padded_vocab // n
    blocks = masked.split(v_l, dim=-1)
    m = torch.stack([b.amax(-1) for b in blocks]).amax(0)
    total = sum(torch.exp(b - m[..., None]).sum(-1) for b in blocks)
    label = masked.gather(-1, labels[..., None].long())[..., 0] - m
    for r, blk in enumerate(blocks):
        hand = iter([m, total, label])      # the group's reductions, in order
        monkeypatch.setattr(collectives, "all_reduce_f32",
                            lambda x, op, group, hand=hand: next(hand))
        x = blk.clone().requires_grad_()
        got = tf._VocabParallelCE.apply(x, labels, r * v_l, object())
        (got * upstream).sum().backward()
        torch.cuda.synchronize()
        err = float((got - nll).detach().abs().max())
        assert err <= 1e-5 * float(nll.detach().abs().max())
        want = ref.grad[..., r * v_l:(r + 1) * v_l]
        assert float((x.grad - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_slots_on_card(dev, n):
    """The expert-parallel capacity dispatch (``moe.dispatch_slots`` on
    indices shifted by each rank's first expert: the reference's
    ``in_range`` form) on CUDA tensors equals the CPU's for one routing of
    granite-moe-3b-a800m's 40 experts, top-8, 1024 tokens, and the ranks'
    kept assignments are the meshless dispatch's."""
    from repro_torch.models import moe
    cfg = configs.get_config("granite-moe-3b-a800m")
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1024, 64, generator=gen)
    w = torch.randn(64, e, generator=gen)
    _, top_i, _ = moe.router_topk(x, w, k)
    cap = moe.capacity(1024, cfg)
    e_l = e // n
    _, whole = moe.dispatch_slots(top_i, e, cap)
    kept = 0
    for r in range(n):
        dst_c, keep_c = moe.dispatch_slots(top_i - r * e_l, e_l, cap)
        dst_g, keep_g = moe.dispatch_slots((top_i - r * e_l).to(dev), e_l,
                                           cap)
        assert torch.equal(dst_g.cpu(), dst_c)
        assert torch.equal(keep_g.cpu(), keep_c)
        kept = kept + keep_c.int()
    assert torch.equal(kept, whole.int())
