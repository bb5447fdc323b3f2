"""head_dim 160 (stablelm-12b) in the port against the JAX package, on the
CPU, inputs from numpy with a seed: the plain flash forward and its
gradients against ``flash/ref.py`` (1e-3), the decode op against
``kvq/ref.py`` with lengths and with a band (1e-5, f32 both, summation
order only), a stablelm-shaped smoke model with ``head_dim=160`` on both
sides (logits, int8 caches, per-slot and lockstep decode, the loss and
every gradient, f32: 1e-4; bf16: 5e-2), and the planner's eligibility,
which differs from the JAX package's on purpose.

The kernels' own arithmetic at 160 is emulated in
``test_torch_flash_fwd_sm90.py``, ``test_torch_flash_bwd_sm90.py`` and
``test_torch_decode_sm90.py`` (their D = 160 cases); the kernels run only
on the card (``chip_smoke.py``'s ``head160_kernels``).  The JAX package's
Pallas flash op refuses 160 and falls back to its plain version; the
port's CUDA path takes it at every supported dtype and never falls back.
"""
from __future__ import annotations

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import plan as jplan
from repro.core.mixed_precision import Policy as JPolicy
from repro.kernels.flash import ref as jfref
from repro.kernels.kvq import ref as jkref
from repro.models import transformer as jtf
from repro_torch import configs, plan
from repro_torch.core.mixed_precision import Policy, scaled_value_and_grad
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.kvq import ops as kvq_ops
from repro_torch.models import bridge
from repro_torch.models import transformer as tf

torch.set_num_threads(2)
ARCH = "stablelm-12b"
D = 160
FLASH_TOL = 1e-3
DECODE_TOL = 1e-5
F32_TOL = 1e-4
BF16_TOL = 5e-2


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def test_full_config_is_head_dim_160():
    cfg = configs.get_config(ARCH)
    assert (cfg.n_heads, cfg.n_kv, cfg.head_dim) == (32, 8, D)
    assert cfg.n_layers == 40 and cfg.d_model == 5120
    assert abs(cfg.param_count() - 12.14e9) < 0.01e9
    assert D in flash_ops.SM90_HEAD_DIMS and D in kvq_ops.SUPPORTED_HEAD_DIMS
    assert ARCH in configs.list_archs() and "minicpm3-4b" in \
        configs.list_archs()


# --------------------------------------------------------------------------
# The plain versions at 160 against the JAX package's references.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("s,h,hkv,window", [(100, 4, 2, 0), (70, 8, 2, 16),
                                            (64, 4, 4, 0), (33, 4, 1, 0)])
def test_plain_flash_forward_and_grads_match_jax(s, h, hkv, window):
    rng = np.random.default_rng(s + h + window)
    q = rng.standard_normal((1, h, s, D)).astype(np.float32)
    k, v = (rng.standard_normal((1, hkv, s, D)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((1, h, s, D)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b, c: jfref.flash_ref(
        a, b, c, causal=True, window=window), *map(jnp.asarray, (q, k, v)))
    wq, wk, wv = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = flash_ops.flash_attention(tq, tk, tv, causal=True, window=window)
    got.backward(torch.from_numpy(do))
    assert _rel(got.detach().numpy(), want) <= FLASH_TOL
    for g, w in ((tq.grad, wq), (tk.grad, wk), (tv.grad, wv)):
        assert _rel(g.numpy(), w) <= FLASH_TOL


def _cache(rng, b, hkv, s):
    k, v = (torch.from_numpy(rng.standard_normal((b, hkv, s, D))
                             .astype(np.float32)) for _ in range(2))
    return (*kvq_ops.quantize_kv(k), *kvq_ops.quantize_kv(v))


@pytest.mark.parametrize("mask", ["lengths", "band"])
def test_plain_decode_matches_jax(mask):
    rng = np.random.default_rng(7)
    b, hkv, g, s = 3, 2, 4, 96
    q = torch.from_numpy(rng.standard_normal((b, hkv * g, D))
                         .astype(np.float32))
    kq, ks, vq, vs = _cache(rng, b, hkv, s)
    lengths = bias = None
    if mask == "lengths":
        lengths = torch.tensor([1, 96, 41], dtype=torch.int32)
    else:
        pos = np.arange(s)[None, :]
        bias = torch.from_numpy(np.where(
            (pos <= 70) & (pos > 70 - 24), 0.0, -1e30)
            .astype(np.float32).repeat(b, 0))
    got = kvq_ops.decode_attention(q, kq, ks, vq, vs, lengths=lengths,
                                   bias=bias)
    j = lambda t: None if t is None else jnp.asarray(t.numpy())  # noqa
    want = jkref.decode_attention_ref(
        j(q.reshape(b, hkv, g, D)), j(kq), j(ks), j(vq), j(vs), j(bias),
        D ** -0.5, lengths=j(lengths))
    assert got.shape == (b, hkv * g, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
        b, hkv * g, D), atol=DECODE_TOL, rtol=0)


# --------------------------------------------------------------------------
# A stablelm-shaped smoke model at head_dim 160.
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), head_dim=D,
                               attn_backend="interpret")
    cfg = dataclasses.replace(configs.smoke_config(ARCH), head_dim=D)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(160))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, cfg, params, tree, bridge.load_jax_params(cfg, tree,
                                                          device="cpu")


def _int8_close(got, want, frac=1e-3):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= frac


def _jforward(params, jcfg, tokens, **kw):
    with warnings.catch_warnings():     # the Pallas op's fallback at 160
        warnings.simplefilter("ignore")
        return jtf.forward(params, jcfg, {"tokens": jnp.asarray(tokens)},
                           **kw)


def test_bridge_round_trip_bit_exact(pair):
    _, cfg, _, tree, model = pair
    assert model.blocks[0].attn.wq.shape == (cfg.d_model, cfg.n_heads * D)
    back = bridge.export_params(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_forward_logits_and_int8_cache(pair):
    jcfg, cfg, params, _, model = pair
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32)
    want, jaux = _jforward(params, jcfg, tokens, policy=JPolicy.full(),
                           build_cache=True)
    got, aux = tf.forward(model, cfg, {"tokens": torch.from_numpy(tokens)},
                          policy=Policy.full(), build_cache=True)
    assert _rel(got.numpy(), want) <= F32_TOL
    jc, c = jaux["cache"], aux["cache"]
    for name in ("k", "v"):
        assert c[name].shape == jc[name].shape
        assert c[name].shape[-1] == D
        _int8_close(c[name].numpy(), np.asarray(jc[name]))
        np.testing.assert_allclose(c[name + "_scale"].numpy(),
                                   np.asarray(jc[name + "_scale"]),
                                   rtol=1e-5)


def test_per_slot_decode_matches_jax(pair):
    """The engine's path: per-row positions, an active mask, the int8
    decode at 160."""
    jcfg, cfg, params, _, model = pair
    rng = np.random.default_rng(1)
    b, s_max = 3, 32
    prompt = rng.integers(0, cfg.vocab, (b, 8)).astype(np.int32)
    _, jaux = _jforward(params, jcfg, prompt, build_cache=True)
    jcache = jtf.grow_cache(jaux["cache"], s_max)
    cache = {n: torch.from_numpy(np.array(x)) for n, x in jcache.items()}
    pos = np.asarray([8, 5, 3], np.int32)
    jcache["pos"] = jnp.asarray(pos)
    cache["pos"] = torch.from_numpy(pos.copy())
    for step in range(6):
        toks = rng.integers(0, cfg.vocab, (b,)).astype(np.int32)
        active = np.asarray([True, step % 2 == 0, step < 4])
        want, jcache = jtf.decode_step(params, jcfg, jcache,
                                       jnp.asarray(toks), quantized=True,
                                       active=jnp.asarray(active))
        got, cache = tf.decode_step(model, cfg, cache, torch.from_numpy(toks),
                                    quantized=True,
                                    active=torch.from_numpy(active))
        assert _rel(got.numpy(), want) <= 1e-3, step
    for name in ("k", "v"):
        _int8_close(cache[name].numpy(), np.asarray(jcache[name]))


def test_lockstep_greedy_decode_matches_jax(pair):
    jcfg, cfg, params, _, model = pair
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32)
    jl, jaux = _jforward(params, jcfg, tokens, build_cache=True)
    tl, aux = tf.forward(model, cfg, {"tokens": torch.from_numpy(tokens)},
                         build_cache=True)
    jcache = jtf.grow_cache(jaux["cache"], 40)
    cache = tf.grow_cache(aux["cache"], 40)
    jt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    tt = tl[:, -1].argmax(-1).to(torch.int32)
    for _ in range(12):
        want, jcache = jtf.decode_step(params, jcfg, jcache, jnp.asarray(jt))
        got, cache = tf.decode_step(model, cfg, cache, tt)
        assert _rel(got.numpy(), want) <= 1e-3
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))
        jt = np.asarray(want).argmax(-1).astype(np.int32)
        tt = got.argmax(-1).to(torch.int32)


def test_loss_and_every_gradient_match_jax(pair):
    jcfg, cfg, params, tree, _ = pair
    model = bridge.load_jax_params(cfg, tree, device="cpu").requires_grad_()
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 25)).astype(np.int32)
    t, lab = toks[:, :-1].copy(), toks[:, 1:].copy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (jl, _), jgrads = jax.value_and_grad(
            lambda p: jtf.loss_fn(p, jcfg, {"tokens": jnp.asarray(t),
                                            "labels": jnp.asarray(lab)}),
            has_aux=True)(params)
    vg = scaled_value_and_grad(lambda m, b: tf.loss_fn(m, cfg, b))
    (loss, _), grads, finite = vg(model, {"tokens": torch.from_numpy(t),
                                          "labels": torch.from_numpy(lab)})
    assert bool(finite)
    assert abs(float(loss) - float(jl)) <= F32_TOL * abs(float(jl))
    got = dict(jax.tree_util.tree_leaves_with_path(bridge.to_jax_tree(grads)))
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jgrads)))
    assert got.keys() == want.keys()
    for path, g in got.items():
        assert _rel(g, want[path]) <= F32_TOL, path


def test_bf16_policy_logits(pair):
    jcfg, cfg, params, tree, _ = pair
    model = bridge.load_jax_params(cfg, tree, device="cpu",
                                   policy=Policy.bf16())
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab, (1, 16)).astype(np.int32)
    want, _ = _jforward(params, jcfg, tokens, policy=JPolicy.bf16())
    got, _ = tf.forward(model, cfg, {"tokens": torch.from_numpy(tokens)},
                        policy=Policy.bf16())
    assert _rel(got.numpy(), want) <= BF16_TOL


def test_flash_eligibility_differs_from_jax_on_purpose():
    """The JAX package's Pallas flash op refuses head_dim 160 and its
    planner budgets the plain path's O(S^2) probabilities there; the port
    runs 160 through its flash kernels, so it budgets flash residuals: a
    known difference, pinned (as hymba's is in test_torch_plan.py)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), head_dim=D,
                               attn_backend="pallas")
    cfg = dataclasses.replace(configs.smoke_config(ARCH), head_dim=D)
    assert plan.flash_training_eligible(cfg, 64)
    assert not jplan.flash_training_eligible(jcfg, 64)
    flash = plan.attn_resid_bytes(cfg, 2, 64)
    assert flash < jplan.attn_resid_bytes(jcfg, 2, 64, 64)
    jp = jplan.profile_transformer(
        jcfg, {"tokens": jax.ShapeDtypeStruct((2, 64), jnp.int32)})
    tp = plan.profile_transformer(
        cfg, {"tokens": torch.empty((2, 64), dtype=torch.int32,
                                    device="meta")})
    assert tp.act_bytes == jp.act_bytes
    assert tp.resid_bytes == (flash,) * cfg.n_layers
