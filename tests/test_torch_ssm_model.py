"""The port's SSM and hybrid decoders (mamba2-130m, hymba-1.5b smoke
configs) against the JAX package's, on the CPU, from the same weights
(``bridge.load_jax_params``) and the same numpy prompts, f32 policy:
prefill logits and every cache leaf, 32 greedy decode steps over the int8
cache (hymba's smoke window is 16, so every step is past it, and its
global layer 0 is masked by length in the port and by a causal bias in
JAX), the windowed decode attention, and the bridge round trip."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.models import attention, bridge
from repro_torch.models import transformer as tf

torch.set_num_threads(2)
LOGIT_TOL = 1e-4    # f32 on both sides: summation order only
PROMPT, STEPS, S_MAX = 32, 32, 64


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(1e-6, np.abs(want).max()))


@pytest.fixture(scope="module", params=["mamba2-130m", "hymba-1.5b"])
def pair(request):
    jcfg = jconfigs.smoke_config(request.param)
    cfg = configs.smoke_config(request.param)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(5))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, cfg, params, tree, bridge.load_jax_params(cfg, tree,
                                                          device="cpu")


@pytest.fixture(scope="module")
def runs(pair):
    """Prefill a (2, PROMPT) prompt, then STEPS greedy decode steps, on
    both sides; each side decodes its own greedy tokens."""
    jcfg, cfg, params, _, model = pair
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    jl, jaux = jtf.forward(params, jcfg, {"tokens": jnp.asarray(tokens)},
                           build_cache=True)
    tl, aux = tf.forward(model, cfg, {"tokens": torch.from_numpy(tokens)},
                         build_cache=True)
    prefill = (np.asarray(jl), tl.numpy(), jaux["cache"],
               {n: t.clone() for n, t in aux["cache"].items()})
    jcache = jtf.grow_cache(jaux["cache"], S_MAX)
    cache = tf.grow_cache(aux["cache"], S_MAX)
    jdecode = jax.jit(lambda p, c, t: jtf.decode_step(p, jcfg, c, t,
                                                      quantized=True))
    jt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    tt = tl[:, -1].argmax(-1).to(torch.int32)
    steps = []
    for _ in range(STEPS):
        want, jcache = jdecode(params, jcache, jnp.asarray(jt))
        got, cache = tf.decode_step(model, cfg, cache, tt, quantized=True)
        steps.append((np.asarray(want), got.numpy()))
        jt = np.asarray(want).argmax(-1).astype(np.int32)
        tt = got.argmax(-1).to(torch.int32)
    return prefill, steps, jcache, cache


def test_bridge_round_trip_bit_exact(pair):
    _, _, _, tree, model = pair
    back = bridge.export_params(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_prefill_logits_and_cache(pair, runs):
    _, cfg, _, _, _ = pair
    (want, got, jc, c), _, _, _ = runs
    assert got.shape == want.shape == (2, PROMPT, cfg.padded_vocab)
    live = slice(0, cfg.vocab)
    assert _rel(got[..., live], want[..., live]) <= LOGIT_TOL
    assert set(c) == set(jc)
    assert int(c["pos"]) == int(jc["pos"]) == PROMPT
    for name in c:
        want_leaf = np.asarray(jc[name])
        assert tuple(c[name].shape) == want_leaf.shape, name
        assert str(c[name].dtype).removeprefix("torch.") == \
            str(want_leaf.dtype), name
    if "k" in c:
        for name in ("k", "v"):
            diff = np.abs(c[name].numpy().astype(np.int32)
                          - np.asarray(jc[name]).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    # the conv tail (bf16 under every policy): at most one bf16 ulp apart
    # (2^-7 relative), where the f32 values straddle a rounding boundary
    np.testing.assert_allclose(c["conv"].float().numpy(),
                               np.asarray(jc["conv"], np.float32),
                               rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(c["ssm"].numpy(), np.asarray(jc["ssm"]),
                               rtol=1e-5, atol=1e-5)


def test_greedy_decode_matches_jax(pair, runs):
    _, cfg, _, _, _ = pair
    _, steps, jcache, cache = runs
    live = slice(0, cfg.vocab)
    for i, (want, got) in enumerate(steps):
        assert _rel(got[:, live], want[:, live]) <= LOGIT_TOL, i
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert int(cache["pos"]) == int(jcache["pos"]) == PROMPT + STEPS
    np.testing.assert_allclose(cache["ssm"].numpy(),
                               np.asarray(jcache["ssm"]), atol=1e-4)


def test_window_schedule(pair):
    jcfg, cfg, _, _, _ = pair
    np.testing.assert_array_equal(tf.layer_windows(cfg),
                                  np.asarray(jtf.layer_windows(jcfg)))


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-130m",
                                  "hymba-1.5b"])
def test_decode_builds_one_mask_per_window(arch, monkeypatch):
    # a decode step builds each distinct window's mask once, not per layer
    cfg = dataclasses.replace(configs.smoke_config(arch), n_layers=4)
    model = tf.init_params(cfg, 0, device="cpu")
    built = []
    real = attention.decode_mask
    monkeypatch.setattr(attention, "decode_mask",
                        lambda *a: built.append(a[-1]) or real(*a))
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    cache["pos"] = torch.tensor(3, dtype=torch.int32)
    tf.decode_step(model, cfg, cache, torch.zeros(2, dtype=torch.int32))
    want = {"llama3-8b": [0], "mamba2-130m": [], "hymba-1.5b": [0, 16]}
    assert sorted(built) == want[arch]


def test_windowed_attn_decode_matches_jax():
    # one windowed layer's decode: the (B, S) band bias on both sides
    cfg = configs.smoke_config("hymba-1.5b")
    jcfg = jconfigs.smoke_config("hymba-1.5b")
    rng = np.random.default_rng(2)
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    w = {n: (rng.normal(size=shape) / shape[0] ** 0.5).astype(np.float32)
         for n, shape in (("wq", (d, h * hd)), ("wk", (d, hkv * hd)),
                          ("wv", (d, hkv * hd)), ("wo", (h * hd, d)))}
    b, s = 3, 48
    kq = rng.integers(-127, 128, (b, hkv, s, hd)).astype(np.int8)
    vq = rng.integers(-127, 128, (b, hkv, s, hd)).astype(np.int8)
    ks = rng.uniform(0.01, 0.02, (b, hkv, s)).astype(np.float32)
    vs = rng.uniform(0.01, 0.02, (b, hkv, s)).astype(np.float32)
    x = rng.normal(size=(b, d)).astype(np.float32)
    pos = 40
    j = jnp.asarray
    want, _ = jattn.attn_decode({k: j(v) for k, v in w.items()}, j(x), jcfg,
                                j(kq), j(ks), j(vq), j(vs), j(pos),
                                window=cfg.window, quantized=True)
    p = tf.Attention(*(torch.from_numpy(w[n]) for n in ("wq", "wk", "wv",
                                                        "wo")))
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    got, _ = attention.attn_decode(p, t(x), cfg, t(kq), t(ks), t(vq), t(vs),
                                   torch.tensor(pos, dtype=torch.int32),
                                   window=cfg.window, quantized=True)
    assert _rel(got.numpy(), want) <= 1e-5


def test_per_slot_pos_refused(pair):
    _, cfg, _, _, model = pair
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    cache["pos"] = torch.tensor([3, 5], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="per-slot"):
        tf.decode_step(model, cfg, cache, torch.zeros(2, dtype=torch.int32))


def test_init_cache_matches_jax(pair):
    jcfg, cfg, _, _, _ = pair
    want = jtf.init_cache(jcfg, 2, 24, quantized=True)
    got = tf.init_cache(cfg, 2, 24, quantized=True, device="cpu")
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == \
            str(leaf.dtype), name
