"""The port's two-tier rolling cache (``models/transformer.py``
``layer_runs`` / ``init_cache_two_tier`` / ``decode_step_two_tier`` and
``attention.attn_decode(rolling=True)``) against the JAX package's, on the
CPU, from the same weights (``bridge.load_jax_params``), f32 policy: the
layer runs, the cache's leaves by name, shape and dtype, and 40 greedy
steps of smoke hymba (window 16, global layer 0) from an empty cache, past
the window, against ``decode_step_two_tier(kvq_backend="ref")``; then the
port's two-tier against its own uniform ``decode_step``; then the cache
over a mesh's model axis (``init_cache_two_tier`` / ``decode_step_two_tier``
with ``mesh=``), gloo ranks running this file (``tests/tp_ranks.py``):
smoke hymba's 2 KV heads put both tiers in heads mode on (1, 2) and in
sequence mode on (1, 4) (the 48 global slots 12 a rank, the 16-slot
window 4 a rank, its rolling write landing on the rank that owns ``pos %
16``); 24 greedy steps, past the window, against JAX's meshless
``decode_step_two_tier`` (the reference's only mesh caller is the
dryrun).

Tolerances: greedy tokens equal; logits within 1e-4 of the largest over
the int8 cache and against the port's own uniform decode (f32 on both
sides, sums in another order; the sharded decode against JAX: 9.5e-7),
within 1e-3 over the unquantized cache,
which stores K/V in bf16: a last-bit difference of an f32 projection can
flip one bf16 rounding (the tolerance of ``test_torch_model.py``'s
unquantized decode).
"""
from __future__ import annotations

import dataclasses
import functools
import sys

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

import tp_ranks

THIS = tp_ranks.pathlib.Path(__file__).resolve()
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


# --------------------------------------------------------------------------
# Over a mesh's model axis (ranks: ``python test_torch_two_tier.py ...``).
# --------------------------------------------------------------------------
MESH_STEPS = 24


def _job_mesh(rank, world, tree, first):
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(data=1, model=world)
    cfg = configs.smoke_config("hymba-1.5b")
    model = bridge.load_jax_params(cfg, tree, device="cpu", mesh=mesh)
    cache = tf.init_cache_two_tier(cfg, 2, S_MAX, device="cpu", mesh=mesh)
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    with torch.no_grad():
        logits, toks, cache = _greedy(
            lambda c, t: tf.decode_step_two_tier(
                model, cfg, c, torch.as_tensor(t).to(torch.int32),
                mesh=mesh), cache, first, MESH_STEPS)
    return {"logits": np.stack(logits), "tokens": toks, "shapes": shapes,
            "pos": int(cache["pos"])}


@functools.lru_cache(maxsize=None)
def _mesh_runs():
    jcfg = jconfigs.smoke_config("hymba-1.5b")
    tree = jax.tree.map(np.asarray, jtf.init_params(
        jcfg, jax.random.PRNGKey(9)))
    first = np.random.default_rng(5).integers(0, 256, (2,)).astype(np.int32)
    tmp = tp_ranks.tmpdir("two_tier_tp_")
    handles = {w: tp_ranks.start(THIS, tmp, "mesh", w, tree=tree,
                                 first=first) for w in (2, 4)}
    params = jtf.init_params(jcfg, jax.random.PRNGKey(9))
    jstep = jax.jit(lambda c, t: jtf.decode_step_two_tier(
        params, jcfg, c, t, kvq_backend="ref"))
    jlog, jtok, _ = _greedy(
        lambda c, t: jstep(c, jnp.asarray(t, jnp.int32)),
        jtf.init_cache_two_tier(jcfg, 2, S_MAX), first, MESH_STEPS)
    return (np.stack(jlog), jtok), {w: tp_ranks.results(h)
                                    for w, h in handles.items()}


@pytest.mark.parametrize("world,mode", [(2, "heads"), (4, "seq")])
def test_sharded_two_tier_decode_matches_jax_meshless(world, mode):
    from repro_torch.launch.mesh import Mesh
    (want, want_tok), runs = _mesh_runs()
    cfg = configs.smoke_config("hymba-1.5b")
    whole = tf.init_cache_two_tier(cfg, 2, S_MAX, device="meta")
    ax = 2 if mode == "heads" else 3
    for out in runs[world]:
        np.testing.assert_array_equal(out["tokens"], want_tok)
        assert _rel(out["logits"], want) <= LOGIT_TOL
        np.testing.assert_array_equal(out["logits"],
                                      runs[world][0]["logits"])
        assert out["pos"] == MESH_STEPS > cfg.window
        for k, shape in out["shapes"].items():
            if k[:1] in ("g", "w"):       # each tier's block
                assert shape[ax] * world == whole[k].shape[ax], k
            else:                         # pos, the conv tail, the SSM
                assert shape == tuple(whole[k].shape), k
    assert tf.cache_specs(cfg, {"wk": whole["wk"].shape},
                          Mesh(data=1, model=world))["wk"] == (
        (None, None, "model", None, None) if mode == "heads"
        else (None, None, None, "model", None))


def test_two_tier_placement_on_a_model_axis():
    """A window whose slots do not divide the axis stays whole (every rank
    reads all of it); a global tier that splits neither way raises."""
    from repro_torch.launch.mesh import Mesh
    cfg = dataclasses.replace(configs.smoke_config("hymba-1.5b"), n_kv=1,
                              window=15)
    cache = tf.init_cache_two_tier(cfg, 2, 48, device="meta",
                                   mesh=Mesh(data=1, model=2))
    assert cache["gk"].shape[3] == 24 and cache["wk"].shape[3] == 15
    assert tf._tier_layouts(cfg, cache, Mesh(data=1, model=2)) == {
        "g": ("seq", 48), "w": ("none", 15)}
    with pytest.raises(ValueError, match="global tier"):
        tf.init_cache_two_tier(cfg, 2, 47, device="meta",
                               mesh=Mesh(data=1, model=2))


if __name__ == "__main__":
    tp_ranks.child({"mesh": _job_mesh}, sys.argv[1], int(sys.argv[2]),
                   int(sys.argv[3]), sys.argv[4])
