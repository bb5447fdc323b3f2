"""The port's mamba2 mixer (``models/ssm.py``) and gated RMSNorm against the
JAX package's, on the CPU, from the same numpy weights and inputs: f32
outputs to 1e-5 of their scale and the SSM state to 1e-5 (sums in another
order), the conv tail (the in_proj output) to 1e-5 in f32 and to one
bf16 rounding in the bf16 decode cache."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.models import layers, ssm
from repro_torch.models.transformer import SSM

torch.set_num_threads(2)
TOL = 1e-5


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(1e-6, np.abs(want).max()))


def _weights(cfg, seed):
    s, d = cfg.ssm, cfg.d_model
    rng = np.random.default_rng(seed)
    conv_dim = s.d_inner + 2 * s.d_state
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa
    return {
        "in_proj": f(d, 2 * s.d_inner + 2 * s.d_state + s.heads) / d ** 0.5,
        "conv_w": f(s.conv_kernel, conv_dim) / 2.0,
        "dt_bias": f(s.heads) * 0.5,
        "a_log": f(s.heads) * 0.5,
        "d_skip": f(s.heads),
        "norm_w": 1.0 + 0.1 * f(s.d_inner),
        "out_proj": f(s.d_inner, d) / s.d_inner ** 0.5,
    }


def _pair(cfg, seed=0):
    w = _weights(cfg, seed)
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    tp = SSM(*(torch.from_numpy(w[k]) for k in SSM.NAMES))
    return jp, tp


@pytest.fixture(params=["mamba2-130m", "hymba-1.5b"])
def cfg(request):
    return configs.smoke_config(request.param)


def test_smoke_config_matches_jax(cfg):
    jcfg = jconfigs.smoke_config(cfg.arch_id)
    assert dataclasses.asdict(cfg.ssm) == dataclasses.asdict(jcfg.ssm)
    assert (cfg.window, cfg.global_layers, cfg.mixer, cfg.d_ff) == \
        (jcfg.window, jcfg.global_layers, jcfg.mixer, jcfg.d_ff)


def test_gated_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    z = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3
    w = rng.normal(size=(32,)).astype(np.float32)
    got = layers.gated_rms_norm(*map(torch.from_numpy, (x, z, w)))
    want = jlayers.gated_rms_norm(*map(jnp.asarray, (x, z, w)))
    assert _rel(got.numpy(), want) <= TOL
    # bf16 activations: silu in f32, cast back before the product
    xb = torch.from_numpy(x).bfloat16()
    got = layers.gated_rms_norm(xb, torch.from_numpy(z), torch.from_numpy(w))
    want = jlayers.gated_rms_norm(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(z), jnp.asarray(w))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= 1e-2


@pytest.mark.parametrize("L", [64, 24, 3])
def test_ssm_block_and_state(cfg, L):
    # 64 = two chunks of 32; 24 and 3 are single chunks of Q = L
    jp, tp = _pair(cfg, seed=L)
    x = np.random.default_rng(L).normal(size=(2, L, cfg.d_model)).astype(
        np.float32)
    want, jst = jssm.ssm_block(jp, jnp.asarray(x), cfg, return_state=True)
    got, st = ssm.ssm_block(tp, torch.from_numpy(x), cfg, return_state=True)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= TOL
    np.testing.assert_allclose(st["conv"].numpy(), np.asarray(jst["conv"]),
                               atol=1e-5)
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(jst["ssm"]),
                               atol=1e-5)
    out, none = ssm.ssm_block(tp, torch.from_numpy(x), cfg)
    assert none is None
    torch.testing.assert_close(out, got, atol=0, rtol=0)


def test_ssm_block_refuses_a_ragged_length(cfg):
    _, tp = _pair(cfg)
    x = torch.zeros((1, cfg.ssm.chunk + 8, cfg.d_model))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssm_block(tp, x, cfg)


def test_ssm_decode_steps(cfg):
    # the conv cache in bf16, as the serving cache keeps it
    jp, tp = _pair(cfg, seed=3)
    s = cfg.ssm
    rng = np.random.default_rng(4)
    b = 2
    conv = rng.normal(size=(b, s.conv_kernel - 1, s.d_inner + 2 * s.d_state))
    state = rng.normal(size=(b, s.heads, s.d_state, s.head_p))
    jconv = jnp.asarray(conv, jnp.bfloat16)
    jstate = jnp.asarray(state, jnp.float32)
    tconv = torch.from_numpy(conv).bfloat16()
    tstate = torch.from_numpy(state.astype(np.float32))
    for _ in range(6):
        x = rng.normal(size=(b, cfg.d_model)).astype(np.float32)
        want, jconv, jstate = jssm.ssm_decode_step(jp, jnp.asarray(x), cfg,
                                                   jconv, jstate)
        got, tconv, tstate = ssm.ssm_decode_step(tp, torch.from_numpy(x),
                                                 cfg, tconv, tstate)
        assert tconv.dtype == torch.bfloat16 and tstate.dtype == torch.float32
        assert _rel(got.numpy(), want) <= TOL
        np.testing.assert_allclose(tconv.float().numpy(),
                                   np.asarray(jconv, np.float32),
                                   rtol=2 ** -7, atol=1e-6)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate),
                                   atol=1e-5, rtol=1e-5)
