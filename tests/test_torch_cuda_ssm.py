"""The SSM slice's CUDA kernels against their plain PyTorch versions, on the
card: the SSD chunk kernel's two designs (``kernels/csrc/ssd_sm90.cu``,
3xTF32 on the tensor cores, for head_p 64; ``ssd.cu``, f32 FMA, for
head_p 16; ``ssd_ops.ssd_route`` chooses) and the decode kernel's dense-bias
entry point and GQA group 5
(``kernels/csrc/flash_decode.cu``), then a 2-layer hybrid through prefill
and decode on the card and on the CPU.  Marked ``cuda``: without a CUDA
device (and nvcc) every test here skips; on the H100 run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_ssm.py
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import tiling
from repro_torch.kernels.kvq import ops as kvq_ops
from repro_torch.kernels.kvq import ref as kvq_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models import attention

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rel):
    """max |got - want| <= rel * max |want| (f32 on both sides: the order
    of the sums differs)."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale + 1e-7, (err, rel * scale)


def _chunk_inputs(g, t, q, n, p, heads, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = torch.randn((g // heads, t, q, n), generator=gen, device=dev)
    b = torch.randn((g // heads, t, q, n), generator=gen, device=dev)
    x = torch.randn((g, t, q, p), generator=gen, device=dev)
    acum = torch.cumsum(-0.2 * torch.rand((g, t, q), generator=gen,
                                          device=dev), dim=-1)
    return c, b, x, acum


@pytest.mark.parametrize("g,t,q,n,p,heads", [
    (8, 3, 128, 128, 64, 4),      # mamba2's widths, head-shared B/C
    (10, 2, 128, 16, 64, 5),      # hymba's
    (6, 2, 64, 128, 64, 3),       # a 64-token prompt: Q = 64
    (4, 1, 100, 16, 16, 1),       # Q not a multiple of 8, smoke widths
    (3, 1, 1, 16, 64, 1),         # a one-token chunk
])
def test_ssd_chunk_kernel_matches_plain(dev, g, t, q, n, p, heads):
    c, b, x, acum = _chunk_inputs(g, t, q, n, p, heads, dev, seed=q + n)
    launches = _launches()
    y, st = ssd_ops.ssd_chunk(c, b, x, acum)
    route = ssd_ops.ssd_route(n, p)
    assert _launches() == {r: k + (r == route) for r, k in launches.items()}
    y_r, st_r = ssd_ref.ssd_chunk_ref(c.repeat_interleave(heads, 0),
                                      b.repeat_interleave(heads, 0), x, acum)
    _close(y, y_r, 1e-4)
    _close(st, st_r, 1e-4)


def _launches():
    return {"sm90": ssd_ops.KERNEL_SM90.launches,
            "fma": ssd_ops.KERNEL.launches}


def _sm90_at_group(c, b, x, acum, group):
    """The sm90 kernel through its C entry point, at a group of heads a CTA
    that ``heads_per_cta`` would not pick."""
    g, t, q, p = x.shape
    n = c.shape[-1]
    y = torch.empty_like(x)
    st = torch.empty((g, t, n, p), device=x.device)
    ssd_ops.KERNEL_SM90(*(z.data_ptr() for z in (c, b, x, acum, y, st)),
                        g, t, q, n, p, g // c.shape[0], group,
                        torch.cuda.current_stream(x.device).cuda_stream)
    return y, st


@pytest.mark.parametrize("g,t,q,n,heads,group", [
    (14, 2, 128, 128, 7, 3),      # 7 heads in groups of 3: a last group of 1
    (10, 3, 100, 16, 5, 2),       # hymba's N, Q = 100, groups of 2 and 1
    (24, 1, 128, 128, 24, None),  # one chunk, 24 heads: heads_per_cta's groups
    (48, 1, 64, 16, 24, None),    # a 64-token prompt, two rows of 24 heads
    (24, 2, 128, 128, 24, 24),    # every head in one CTA
])
def test_ssd_sm90_head_groups(dev, g, t, q, n, heads, group):
    # the scores are computed once per CTA's group of heads: every group
    # size gives every head the same result as the plain version
    c, b, x, acum = _chunk_inputs(g, t, q, n, 64, heads, dev, seed=g + q)
    launches = _launches()
    y, st = (ssd_ops.ssd_chunk(c, b, x, acum) if group is None
             else _sm90_at_group(c, b, x, acum, group))
    assert _launches() == {"sm90": launches["sm90"] + 1,
                           "fma": launches["fma"]}
    y_r, st_r = ssd_ref.ssd_chunk_ref(c.repeat_interleave(heads, 0),
                                      b.repeat_interleave(heads, 0), x, acum)
    _close(y, y_r, 1e-4)
    _close(st, st_r, 1e-4)


def test_ssd_op_card_matches_cpu(dev):
    gen = torch.Generator().manual_seed(3)
    bsz, L, h, p, n = 2, 256, 4, 64, 128
    x = torch.randn((bsz, L, h, p), generator=gen)
    dt = 0.001 + 0.099 * torch.rand((bsz, L, h), generator=gen)
    a = -(0.5 + 1.5 * torch.rand((h,), generator=gen))
    bm = torch.randn((bsz, L, n), generator=gen)
    cm = torch.randn((bsz, L, n), generator=gen)
    d = torch.randn((h,), generator=gen)
    args = (x, dt, a, bm, cm, d)
    y_c, s_c = ssd_ops.ssd(*args, chunk=128, return_state=True)
    before = ssd_ops.KERNEL_SM90.launches          # head_p 64: the sm90 route
    y_g, s_g = ssd_ops.ssd(*(z.to(dev) for z in args), chunk=128,
                           return_state=True)
    assert ssd_ops.KERNEL_SM90.launches == before + 1
    _close(y_g.cpu(), y_c, 1e-4)
    _close(s_g.cpu(), s_c, 1e-4)


def test_ssd_kernel_refuses_autograd_and_bad_shapes(dev):
    # autograd is no longer refused: a chunk that needs a gradient goes
    # through _SSDChunkFn, whose backward launches ssd_bwd.cu; a shape no
    # kernel takes still raises
    c, b, x, acum = _chunk_inputs(2, 1, 32, 16, 16, 1, dev)
    before = ssd_ops.KERNEL_BWD.launches
    y, st = ssd_ops.ssd_chunk(c, b, x.requires_grad_(), acum)
    (gx,) = torch.autograd.grad((y.sum() + st.sum()), [x])
    assert ssd_ops.KERNEL_BWD.launches == before + 1
    dy, dst = torch.ones_like(y), torch.ones_like(st)
    _close(gx, ssd_ref.ssd_chunk_bwd_ref(c, b, x.detach(), acum, dy,
                                         dst)[2], 1e-4)
    c, b, x, acum = _chunk_inputs(2, 1, 32, 32, 16, 1, dev)
    with pytest.raises(ValueError, match="d_state"):
        ssd_ops.ssd_chunk(c, b, x, acum)


def _decode_inputs(b, hkv, g, s, d, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, hkv * g, d), generator=gen, device=dev)
    kq, ks = kvq_ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=dev))
    vq, vs = kvq_ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=dev))
    return q, kq, ks, vq, vs


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_decode_bias_kernel_matches_plain(dev, splits):
    # hymba's decode shape: G = 5, D = 64, a window band of 1024 ending at
    # pos (every split but the band's sees only -1e30 entries somewhere)
    b, hkv, g, d, s, window = 4, 5, 5, 64, 2080, 1024
    q, kq, ks, vq, vs = _decode_inputs(b, hkv, g, d=d, s=s, dev=dev,
                                       seed=splits)
    pos = torch.tensor(2050, dtype=torch.int32, device=dev)
    lengths, bias = attention.decode_mask(pos, b, s, window)
    assert lengths is None and bias.shape == (b, s)
    before = kvq_ops.BIAS_KERNEL.launches
    out, cnt = kvq_ops.decode_attention(q, kq, ks, vq, vs, bias=bias,
                                        splits=splits, counts=True)
    assert kvq_ops.BIAS_KERNEL.launches == before + 1
    assert torch.isfinite(out).all()
    want = kvq_ref.decode_attention_splitk_ref(
        q.reshape(b, hkv, g, d), kq, ks, vq, vs, d ** -0.5, bias=bias,
        splits=splits).reshape(b, hkv * g, d)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    twin = tiling.decode_tile_step_counts(s, None, splits=splits)
    assert cnt.tolist() == [[twin["counts"][0]] * hkv] * b


def test_decode_group5_lengths_matches_plain(dev):
    b, hkv, g, d, s = 3, 5, 5, 64, 2080
    q, kq, ks, vq, vs = _decode_inputs(b, hkv, g, d=d, s=s, dev=dev, seed=9)
    lens = [1, 2080, 1033]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    out, cnt = kvq_ops.decode_attention(q, kq, ks, vq, vs, lengths=lengths,
                                        splits=4, counts=True)
    want = kvq_ref.decode_attention_ref(
        q.reshape(b, hkv, g, d), kq, ks, vq, vs, None, d ** -0.5,
        lengths=lengths).reshape(b, hkv * g, d)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    twin = tiling.decode_tile_step_counts(s, lens, splits=4)
    assert cnt.tolist() == [[row] * hkv for row in twin["counts"]]


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_ssm_models_card_vs_cpu(dev, arch):
    from repro_torch.models import bridge, transformer as tf
    cfg = dataclasses.replace(configs.smoke_config(arch), d_model=256,
                              vocab=512)
    if cfg.mixer == "hybrid":
        cfg = dataclasses.replace(cfg, n_heads=10, n_kv=2, head_dim=64)
    cpu = tf.init_params(cfg, 0, device="cpu")
    gpu = bridge.load_jax_params(cfg, bridge.export_params(cpu), device=dev)
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        lw, aux_c = tf.forward(cpu, cfg, {"tokens": tokens}, build_cache=True)
        lg, aux_g = tf.forward(gpu, cfg, {"tokens": tokens.to(dev)},
                               build_cache=True)
        _close(lg.cpu(), lw, 1e-4)
        cache_c = tf.grow_cache(aux_c["cache"], 96)
        cache_g = {n: t.to(dev) for n, t in cache_c.items()}
        tok = lw[:, -1].argmax(-1).to(torch.int32)
        for _ in range(24):                 # past the smoke window of 16
            lw, cache_c = tf.decode_step(cpu, cfg, cache_c, tok)
            lg, cache_g = tf.decode_step(gpu, cfg, cache_g, tok.to(dev))
            _close(lg.cpu(), lw, 1e-3)
            tok = lw.argmax(-1).to(torch.int32)
