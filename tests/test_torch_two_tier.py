"""The port's two-tier rolling cache (``models/transformer.py``
``layer_runs`` / ``init_cache_two_tier`` / ``decode_step_two_tier`` and
``attention.attn_decode(rolling=True)``) against the JAX package's, on the
CPU, from the same weights (``bridge.load_jax_params``), f32 policy: the
layer runs, the cache's leaves by name, shape and dtype, and 40 greedy
steps of smoke hymba (window 16, global layer 0) from an empty cache, past
the window, against ``decode_step_two_tier(kvq_backend="ref")``; then the
port's two-tier against its own uniform ``decode_step``.

Tolerances: greedy tokens equal; logits within 1e-4 of the largest over
the int8 cache and against the port's own uniform decode (f32 on both
sides, sums in another order), within 1e-3 over the unquantized cache,
which stores K/V in bf16: a last-bit difference of an f32 projection can
flip one bf16 rounding (the tolerance of ``test_torch_model.py``'s
unquantized decode).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.models import bridge
from repro_torch.models import transformer as tf

torch.set_num_threads(2)
LOGIT_TOL, BF16_CACHE_TOL = 1e-4, 1e-3
STEPS, S_MAX = 40, 48


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(1e-6, np.abs(want).max()))


@pytest.mark.parametrize("arch,smoke,change", [
    ("hymba-1.5b", True, {}),
    ("hymba-1.5b", False, {}),                      # globals 0, 15, 31
    ("hymba-1.5b", True, {"global_layers": (1,)}),  # a window run first
    ("hymba-1.5b", False, {"global_layers": (3, 4, 20)}),
])
def test_layer_runs_equal_jax(arch, smoke, change):
    get = "smoke_config" if smoke else "get_config"
    jcfg = dataclasses.replace(getattr(jconfigs, get)(arch), **change)
    cfg = dataclasses.replace(getattr(configs, get)(arch), **change)
    assert tf.layer_runs(cfg) == jtf.layer_runs(jcfg)


@pytest.mark.parametrize("s_max", [64, 8])         # 8 < the window of 16
@pytest.mark.parametrize("quantized", [True, False])
def test_init_cache_two_tier_leaves_equal_jax(s_max, quantized):
    jcfg = jconfigs.smoke_config("hymba-1.5b")
    cfg = configs.smoke_config("hymba-1.5b")
    want = jtf.init_cache_two_tier(jcfg, 2, s_max, quantized=quantized)
    got = tf.init_cache_two_tier(cfg, 2, s_max, quantized=quantized,
                                 device="cpu")
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == tuple(w.shape), name
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
        assert not g.any()


def test_init_cache_two_tier_refuses_an_unwindowed_arch():
    with pytest.raises(ValueError, match="two-tier"):
        tf.init_cache_two_tier(configs.smoke_config("llama3-8b"), 1, 16,
                               device="cpu")


@pytest.fixture(scope="module")
def hymba():
    jcfg = jconfigs.smoke_config("hymba-1.5b")
    cfg = configs.smoke_config("hymba-1.5b")
    params = jtf.init_params(jcfg, jax.random.PRNGKey(9))
    model = bridge.load_jax_params(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return jcfg, cfg, params, model


def _greedy(step, cache, first, steps=STEPS):
    """``steps`` greedy steps from ``first``: (logits per step, tokens)."""
    tok, logits, toks = first, [], []
    for _ in range(steps):
        lg, cache = step(cache, tok)
        logits.append(np.asarray(lg, np.float32))
        tok = lg.argmax(-1)
        toks.append(np.asarray(tok))
    return logits, np.stack(toks), cache


@pytest.mark.parametrize("quantized", [True, False])
def test_two_tier_decode_matches_jax(hymba, quantized):
    jcfg, cfg, params, model = hymba
    first = np.random.default_rng(3).integers(0, cfg.vocab, (2,)).astype(
        np.int32)
    jstep = jax.jit(lambda c, t: jtf.decode_step_two_tier(
        params, jcfg, c, t, quantized=quantized, kvq_backend="ref"))
    jlog, jtok, jcache = _greedy(
        lambda c, t: jstep(c, jnp.asarray(t, jnp.int32)),
        jtf.init_cache_two_tier(jcfg, 2, S_MAX, quantized=quantized),
        first)
    with torch.no_grad():
        tlog, ttok, cache = _greedy(
            lambda c, t: tf.decode_step_two_tier(
                model, cfg, c, torch.as_tensor(t).to(torch.int32),
                quantized=quantized),
            tf.init_cache_two_tier(cfg, 2, S_MAX, quantized=quantized,
                                   device="cpu"),
            first)
    assert np.array_equal(ttok, jtok)
    assert max(_rel(a, b) for a, b in zip(tlog, jlog)) <= (
        LOGIT_TOL if quantized else BF16_CACHE_TOL)
    assert int(cache["pos"]) == int(jcache["pos"]) == STEPS
    # the rolling window buffer holds the last 16 tokens, at pos % 16
    assert cache["wk"].shape[3] == cfg.window < STEPS
    if quantized:
        assert np.array_equal(cache["wk"].numpy(), np.asarray(jcache["wk"]))
        assert np.array_equal(cache["gk"].numpy(), np.asarray(jcache["gk"]))


def test_two_tier_matches_uniform_decode(hymba):
    _, cfg, _, model = hymba
    first = np.random.default_rng(4).integers(0, cfg.vocab, (2,)).astype(
        np.int32)
    runs = {}
    with torch.no_grad():
        for name, init, step in (
                ("uniform", tf.init_cache, tf.decode_step),
                ("two_tier", tf.init_cache_two_tier,
                 tf.decode_step_two_tier)):
            runs[name] = _greedy(
                lambda c, t, step=step: step(
                    model, cfg, c, torch.as_tensor(t).to(torch.int32)),
                init(cfg, 2, S_MAX, device="cpu"), first)
    (ulog, utok, ucache), (tlog, ttok, tcache) = runs["uniform"], \
        runs["two_tier"]
    assert np.array_equal(ttok, utok)
    assert max(_rel(a, b) for a, b in zip(tlog, ulog)) <= LOGIT_TOL
    # the global layer's tier holds what the uniform cache holds for layer 0
    assert torch.equal(tcache["gk"][0], ucache["k"][0])
    # the SSM state follows the same tokens through the same steps
    torch.testing.assert_close(tcache["ssm"], ucache["ssm"], atol=0, rtol=0)
