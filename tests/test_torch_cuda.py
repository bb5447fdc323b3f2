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

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("s,window,d,g", [(1, 0, 128, 4), (63, 0, 64, 1),
                                          (65, 16, 128, 2), (200, 0, 64, 8),
                                          (257, 100, 128, 4)])
def test_flash_kernel_matches_plain(dev, s, window, d, g):
    gen = torch.Generator(device=dev).manual_seed(s)
    hkv = 2
    q = torch.randn((hkv * g, s, d), generator=gen, device=dev)
    k = torch.randn((hkv, s, d), generator=gen, device=dev)
    v = torch.randn((hkv, s, d), generator=gen, device=dev)
    o, m, l, cnt = flash_ops.flash_attention_fwd(q, k, v, window=window,
                                                 counts=True)
    o_r, m_r, l_r = flash_ref.flash_fwd_ref(q, k, v, window=window)
    torch.testing.assert_close(o, o_r, atol=1e-4, rtol=0)
    torch.testing.assert_close(m, m_r, atol=1e-4, rtol=0)
    torch.testing.assert_close(l, l_r, rtol=1e-4, atol=0)
    assert cnt.tolist() == [flash_ops.expected_counts(s, window=window)] \
        * (hkv * g)


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


def test_unsupported_shapes_raise(dev):
    x = torch.zeros((2, 8, 16), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention_fwd(x, x, x)
    q = torch.zeros((1, 6, 64), device=dev)
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
