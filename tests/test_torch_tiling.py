"""The port's tile arithmetic (repro_torch.kernels.tiling) value for value
against the JAX package's (repro.kernels.tiling), over a grid of sequence
lengths, block sizes, windows, lengths and splits."""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro.kernels import tiling as jt
from repro_torch.kernels import tiling as tt

torch.set_num_threads(2)

FLASH_GRID = [(128, 128, 128), (256, 128, 128), (512, 128, 64),
              (384, 64, 128), (40, 40, 40), (192, 64, 64)]


@pytest.mark.parametrize("s,bq,bk", FLASH_GRID)
def test_flash_bounds_and_visits(s, bq, bk):
    for causal, window in itertools.product((True, False), (0, 1, 16, 100)):
        for kv_len in sorted({s, s - 1, s // 2 + 3, 1}):
            kw = dict(bq=bq, bk=bk, causal=causal, window=window,
                      kv_len=kv_len)
            for qi in range(s // bq):
                assert tt.kv_tile_bounds(qi, **kw) == \
                    jt.kv_tile_bounds(qi, **kw)
            for ki in range(s // bk):
                assert tt.q_tile_bounds(ki, n_q=s // bq, **kw) == \
                    jt.q_tile_bounds(ki, n_q=s // bq, **kw)
            assert tt.kv_visits(s, **kw) == jt.kv_visits(s, **kw)
            assert tt.q_visits(s, **kw) == jt.q_visits(s, **kw)


@pytest.mark.parametrize("s", [8, 40, 128, 256, 1024])
def test_tile_step_counts(s):
    for bq, bk, causal, window in itertools.product(
            (64, 128), (64, 128), (True, False), (0, 16, 300)):
        kw = dict(bq=bq, bk=bk, causal=causal, window=window)
        assert tt.tile_step_counts(s, **kw) == jt.tile_step_counts(s, **kw)
        assert tt.tile_step_counts(s, kv_len=max(1, s - 5), **kw) == \
            jt.tile_step_counts(s, kv_len=max(1, s - 5), **kw)


@pytest.mark.parametrize("s", [1, 6, 64, 96, 512, 1536, 2048])
def test_decode_grid(s):
    for block_s, splits in itertools.product((16, 128, 512, 1000),
                                             (1, 2, 3, 4, 7)):
        assert tt.resolve_decode_block(s, block_s) == \
            jt.resolve_decode_block(s, block_s)
        assert tt.resolve_decode_grid(s, block_s=block_s, splits=splits) == \
            jt.resolve_decode_grid(s, block_s=block_s, splits=splits)


@pytest.mark.parametrize("s,block_s", [(64, 16), (512, 128), (2048, 512),
                                       (1536, 512), (96, 32)])
def test_decode_counts_and_last_tile(s, block_s):
    rng = np.random.default_rng(s)
    lengths = [0, 1, s, s - 1, block_s, block_s + 1] + \
        [int(x) for x in rng.integers(1, s + 1, 6)]
    bs, ns, _, _ = tt.resolve_decode_grid(s, block_s=block_s)
    for ln in lengths:
        assert tt.decode_last_live_tile(ln, bs=bs, ns=ns) == \
            jt.decode_last_live_tile(ln, bs=bs, ns=ns)
    for splits in (1, 2, 3, 4, 5):
        assert tt.decode_tile_step_counts(s, lengths, block_s=block_s,
                                          splits=splits) == \
            jt.decode_tile_step_counts(s, lengths, block_s=block_s,
                                       splits=splits)
    assert tt.decode_tile_step_counts(s, block_s=block_s) == \
        jt.decode_tile_step_counts(s, block_s=block_s)
