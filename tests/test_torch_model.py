"""The port's dense decoder against the JAX package's, at smoke size, from
the same weights (``bridge.load_jax_params``) and the same numpy inputs:
prefill logits and int8 cache, eight per-slot decode steps with an active
mask, the padded-vocab mask, the loss, and the bridge round trip; for
llama3-8b and glm4-9b (2 KV heads, half-dim rotary)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.mixed_precision import Policy as JPolicy
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.core.mixed_precision import Policy
from repro_torch.models import bridge
from repro_torch.models import transformer as tf

torch.set_num_threads(2)
LOGIT_RTOL = 1e-4      # f32 on both sides: summation order only
DECODE_TOL = 1e-3      # after int8 caches that may differ by one step at .5
# bf16 policy: both sides round activations to bf16 after every matmul and
# norm, but at different points (XLA fuses, PyTorch runs op by op), so one
# bf16 ulp (2^-8 relative) can differ per op; over 2 layers that stays
# within a few percent of the logit scale
BF16_TOL = 5e-2


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / max(1e-6, np.max(np.abs(want))))


def _int8_close(got, want, frac=1e-3):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= frac


@pytest.fixture(scope="module", params=[
    ("llama3-8b", 256), ("llama3-8b", 250), ("glm4-9b", 256),
    ("glm4-9b", 250)],
    # llama keeps its earlier ids
    ids=lambda p: ("" if p[0] == "llama3-8b" else f"{p[0]}-")
    + f"vocab{p[1]}")
def pair(request):
    arch, vocab = request.param
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch),
                               vocab=vocab, attn_backend="interpret")
    cfg = dataclasses.replace(configs.smoke_config(arch), vocab=vocab)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(vocab))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, cfg, params, tree, bridge.load_jax_params(cfg, tree,
                                                          device="cpu")


def test_bridge_round_trip_bit_exact(pair):
    _, _, _, tree, model = pair
    back = bridge.export_params(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_forward_logits_and_cache(pair):
    jcfg, cfg, params, _, model = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    want, jaux = jtf.forward(params, jcfg, {"tokens": jnp.asarray(tokens)},
                             policy=JPolicy.full(), build_cache=True)
    got, aux = tf.forward(model, cfg, {"tokens": torch.from_numpy(tokens)},
                          policy=Policy.full(), build_cache=True)
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape == (2, 24, cfg.padded_vocab)
    live = slice(0, cfg.vocab)
    assert _rel_err(got[..., live], want[..., live]) <= LOGIT_RTOL
    np.testing.assert_array_equal(got[..., cfg.vocab:], want[..., cfg.vocab:])
    jc, c = jaux["cache"], aux["cache"]
    assert int(c["pos"]) == int(jc["pos"]) == 24
    for name in ("k", "v"):
        assert c[name].shape == jc[name].shape
        _int8_close(c[name].numpy(), np.asarray(jc[name]))
        np.testing.assert_allclose(c[name + "_scale"].numpy(),
                                   np.asarray(jc[name + "_scale"]),
                                   rtol=1e-5)


def test_per_slot_decode_steps(pair):
    jcfg, cfg, params, _, model = pair
    rng = np.random.default_rng(1)
    b, s_max = 3, 32
    prompt = rng.integers(0, cfg.vocab, (b, 8)).astype(np.int32)
    _, jaux = jtf.forward(params, jcfg, {"tokens": jnp.asarray(prompt)},
                          build_cache=True)
    jcache = jtf.grow_cache(jaux["cache"], s_max)
    _, aux = tf.forward(model, cfg, {"tokens": torch.from_numpy(prompt)},
                        build_cache=True)
    cache = tf.grow_cache(aux["cache"], s_max)
    # the JAX int8 entries are the reference: start both from them
    for name in ("k", "v", "k_scale", "v_scale"):
        cache[name] = torch.from_numpy(np.array(jcache[name]))
    pos = np.asarray([8, 5, 3], np.int32)
    jcache["pos"] = jnp.asarray(pos)
    cache["pos"] = torch.from_numpy(pos.copy())
    jdecode = jax.jit(lambda p, c, t, a: jtf.decode_step(
        p, jcfg, c, t, quantized=True, active=a))
    for step in range(8):
        toks = rng.integers(0, cfg.vocab, (b,)).astype(np.int32)
        active = np.asarray([True, step % 2 == 0, step < 5])
        want, jcache = jdecode(params, jcache, jnp.asarray(toks),
                               jnp.asarray(active))
        got, cache = tf.decode_step(model, cfg, cache,
                                    torch.from_numpy(toks), quantized=True,
                                    active=torch.from_numpy(active))
        live = slice(0, cfg.vocab)
        assert _rel_err(got.numpy()[:, live],
                        np.asarray(want)[:, live]) <= DECODE_TOL, step
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    for name in ("k", "v"):
        _int8_close(cache[name].numpy(), np.asarray(jcache[name]))


def test_bf16_policy_logits(pair):
    jcfg, cfg, params, tree, _ = pair
    model = bridge.load_jax_params(cfg, tree, device="cpu",
                                   policy=Policy.bf16())
    assert model.embed.dtype == torch.bfloat16
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (1, 16))
    tokens = tokens.astype(np.int32)
    want, _ = jtf.forward(params, jcfg, {"tokens": jnp.asarray(tokens)},
                          policy=JPolicy.bf16())
    got, _ = tf.forward(model, cfg, {"tokens": torch.from_numpy(tokens)},
                        policy=Policy.bf16())
    assert got.dtype == torch.float32
    live = slice(0, cfg.vocab)
    assert _rel_err(got.numpy()[..., live],
                    np.asarray(want)[..., live]) <= BF16_TOL


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_equals_jax_field_by_field(arch):
    """Every arch of the JAX package is registered, with the JAX config's
    fields (the port has no ``attn_backend``: it dispatches on the
    device) and its parameter counts."""
    assert sorted(configs.list_archs()) == sorted(jconfigs.list_archs())
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    ported = {f.name for f in dataclasses.fields(cfg)}
    assert {f.name for f in dataclasses.fields(jcfg)} - ported == \
        {"attn_backend"}
    for name in sorted(ported):
        got, want = getattr(cfg, name), getattr(jcfg, name)
        if dataclasses.is_dataclass(want):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, name
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.padded_vocab == jcfg.padded_vocab
    smoke, jsmoke = configs.smoke_config(arch), jconfigs.smoke_config(arch)
    assert smoke.param_count() == jsmoke.param_count()
    assert smoke.encoder == (None if jsmoke.encoder is None else type(
        smoke.encoder)(**dataclasses.asdict(jsmoke.encoder)))
    assert smoke.mrope_sections == jsmoke.mrope_sections


def test_scalar_pos_decode_and_unquantized_cache(pair):
    # the lockstep path: one 0-d position for every row, bf16 cache
    jcfg, cfg, params, _, model = pair
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    _, jaux = jtf.forward(params, jcfg, {"tokens": jnp.asarray(prompt)},
                          build_cache=True, cache_quantized=False)
    _, aux = tf.forward(model, cfg, {"tokens": torch.from_numpy(prompt)},
                        build_cache=True, cache_quantized=False)
    jcache = jtf.grow_cache(jaux["cache"], 16)
    cache = tf.grow_cache(aux["cache"], 16)
    assert cache["k"].dtype == torch.bfloat16
    jdecode = jax.jit(lambda p, c, t: jtf.decode_step(p, jcfg, c, t,
                                                      quantized=False))
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
        want, jcache = jdecode(params, jcache, jnp.asarray(toks))
        got, cache = tf.decode_step(model, cfg, cache,
                                    torch.from_numpy(toks), quantized=False)
        live = slice(0, cfg.vocab)
        assert _rel_err(got.numpy()[:, live],
                        np.asarray(want)[:, live]) <= DECODE_TOL
    assert int(cache["pos"]) == int(jcache["pos"]) == 9


def test_loss_matches_jax(pair):
    jcfg, cfg, params, _, model = pair
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 25)).astype(np.int32)
    t, lab = toks[:, :-1].copy(), toks[:, 1:].copy()
    want, jaux = jtf.loss_fn(params, jcfg, {"tokens": jnp.asarray(t),
                                            "labels": jnp.asarray(lab)})
    with torch.no_grad():
        got, aux = tf.loss_fn(model, cfg, {"tokens": torch.from_numpy(t),
                                           "labels": torch.from_numpy(lab)})
    assert abs(float(got) - float(want)) <= LOGIT_RTOL * abs(float(want))
    assert aux["moe_aux"] == jaux["moe_aux"] == 0.0
