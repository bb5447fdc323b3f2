"""MLA (minicpm3-4b's multi-head latent attention) in the port against the
JAX package, on the CPU, at smoke size, inputs from numpy with a seed:
``gqa_attention`` one-shot and KV-chunked, ``mla_block``, ``mla_decode``
over a bf16 latent cache, the smoke model's logits, latent caches, lockstep
decode, loss and every gradient, greedy lockstep tokens through
``launch/serve.py``'s driver, the bridge round trip, the engine's refusal
and the planner's MLA profile.

No kernel lies on MLA's path in the reference (its prefill and training
call the plain ``gqa_attention``, its decode plain einsums), so none lies
on the port's: every counter stays 0.  Tolerances: f32 on both sides, so
summation order only (1e-4 relative, 1e-5 on the attention outputs);
bf16 latents round the same f32 values on both sides (exact but for a
one-ulp tie, 1e-2 relative).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import plan as jplan
from repro.core.mixed_precision import Policy as JPolicy
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch import configs, plan
from repro_torch.core.mixed_precision import Policy, scaled_value_and_grad
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.kvq import ops as kvq_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention, bridge
from repro_torch.models import transformer as tf
from repro_torch.serve import ServeEngine, supports

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "minicpm3-4b"
F32_TOL = 1e-4
ATTN_TOL = 1e-5
LAT_TOL = 1e-2
KERNELS = (flash_ops.KERNEL, flash_ops.FWD_SM90, flash_ops.BWD_DELTA,
           flash_ops.BWD_DQ, flash_ops.BWD_DKV, flash_ops.BWD_DQ_SM90,
           flash_ops.BWD_DKV_SM90, kvq_ops.KERNEL, kvq_ops.BIAS_KERNEL)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def _launches():
    return [k.launches for k in KERNELS]


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.smoke_config(ARCH)
    cfg = configs.smoke_config(ARCH)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(11))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, cfg, params, tree, bridge.load_jax_params(cfg, tree,
                                                          device="cpu")


# --------------------------------------------------------------------------
# gqa_attention: the plain attention MLA runs, one-shot and chunked.
# --------------------------------------------------------------------------
def _qkv(rng, b, sq, sk, h, hkv, d, dv):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dv)).astype(np.float32))


def _both_gqa(q, k, v, pos, **kw):
    want = jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), q_pos=jnp.asarray(pos),
                               k_pos=jnp.asarray(pos), **kw)
    got = attention.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  q_pos=torch.from_numpy(pos),
                                  k_pos=torch.from_numpy(pos), **kw)
    return got.numpy(), np.asarray(want)


# (S, H, Hkv, D, Dv, window, sm_scale): MLA's shape (Hkv = H, Dv != D, an
# explicit scale), GQA groups, a window
ONE_SHOT = [(24, 4, 4, 16, 8, 0, 16 ** -0.5), (24, 4, 2, 16, 16, 0, None),
            (33, 6, 3, 12, 8, 8, None), (1, 4, 4, 16, 8, 0, 0.3)]


@pytest.mark.parametrize("s,h,hkv,d,dv,window,scale", ONE_SHOT)
def test_gqa_attention_one_shot_matches_jax(s, h, hkv, d, dv, window, scale):
    rng = np.random.default_rng(s + h + d)
    q, k, v = _qkv(rng, 2, s, s, h, hkv, d, dv)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    got, want = _both_gqa(q, k, v, pos, window=window, sm_scale=scale)
    assert got.shape == (2, s, h, dv)
    assert _rel(got, want) <= ATTN_TOL


@pytest.mark.parametrize("s,window", [(40, 0), (37, 0), (37, 9)])
def test_gqa_attention_chunked_matches_jax(s, window, monkeypatch):
    """The KV-chunked online softmax, reached at smoke size by shrinking
    the threshold and the chunk in both packages (37 keys: a ragged last
    chunk, its padded keys dropped by the causal mask)."""
    for mod in (attention, jattn):
        monkeypatch.setattr(mod, "CHUNKED_THRESHOLD", 16)
        monkeypatch.setattr(mod, "KV_CHUNK", 8)
    rng = np.random.default_rng(s + window)
    q, k, v = _qkv(rng, 2, s, s, 4, 4, 16, 8)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    got, want = _both_gqa(q, k, v, pos, window=window, sm_scale=0.25)
    assert _rel(got, want) <= ATTN_TOL
    # the chunked path and the one-shot path compute one function
    monkeypatch.setattr(attention, "CHUNKED_THRESHOLD", 4096)
    monkeypatch.setattr(attention, "KV_CHUNK", 1024)
    one = attention.gqa_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        q_pos=torch.from_numpy(pos), k_pos=torch.from_numpy(pos),
        window=window, sm_scale=0.25).numpy()
    assert _rel(got, one) <= ATTN_TOL


# --------------------------------------------------------------------------
# mla_block / mla_decode on one layer's weights.
# --------------------------------------------------------------------------
def _layer(params, model, i=0):
    jp = jax.tree.map(lambda x: x[i], params["blocks"]["attn"])
    return jp, model.blocks[i].attn


def test_mla_block_matches_jax(pair):
    jcfg, cfg, params, _, model = pair
    jp, p = _layer(params, model)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    want, (jlat, jkr) = jattn.mla_block(jp, jnp.asarray(x), jcfg,
                                        positions=jnp.asarray(pos))
    before = _launches()
    got, (lat, kr) = attention.mla_block(p, torch.from_numpy(x), cfg,
                                         positions=torch.from_numpy(pos))
    assert _launches() == before
    assert _rel(got.numpy(), want) <= F32_TOL
    assert lat.shape == (2, 20, cfg.mla.kv_lora_rank)
    assert kr.shape == (2, 20, 1, cfg.mla.qk_rope_dim)
    assert _rel(lat.numpy(), jlat) <= F32_TOL
    assert _rel(kr.numpy(), jkr) <= F32_TOL


def test_mla_decode_matches_jax_and_writes_in_place(pair):
    jcfg, cfg, params, _, model = pair
    jp, p = _layer(params, model, 1)
    m = cfg.mla
    rng = np.random.default_rng(2)
    s_max, b = 24, 3
    lat = rng.standard_normal((b, s_max, m.kv_lora_rank)).astype(np.float32)
    rope = rng.standard_normal((b, s_max, m.qk_rope_dim)).astype(np.float32)
    jl = jnp.asarray(lat, jnp.bfloat16)
    jr = jnp.asarray(rope, jnp.bfloat16)
    cl = torch.from_numpy(lat).to(torch.bfloat16)
    cr = torch.from_numpy(rope).to(torch.bfloat16)
    for pos in (5, 6, 7, 23):
        x = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
        want, (jl, jr) = jattn.mla_decode(jp, jnp.asarray(x), jcfg, jl, jr,
                                          jnp.int32(pos))
        got, (cl2, cr2) = attention.mla_decode(
            p, torch.from_numpy(x), cfg, cl, cr,
            torch.tensor(pos, dtype=torch.int32))
        assert cl2 is cl and cr2 is cr            # updated in place
        assert _rel(got.numpy(), want) <= F32_TOL, pos
        assert cl.dtype == torch.bfloat16
        assert _rel(cl.float().numpy(), np.asarray(jl, np.float32)) \
            <= LAT_TOL
        assert _rel(cr.float().numpy(), np.asarray(jr, np.float32)) \
            <= LAT_TOL


# --------------------------------------------------------------------------
# The smoke model.
# --------------------------------------------------------------------------
def test_bridge_round_trip_bit_exact(pair):
    _, _, _, tree, model = pair
    assert isinstance(model.blocks[0].attn, tf.MLA)
    back = bridge.export_params(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_init_params_matches_jax_shapes(pair):
    jcfg, cfg, params, _, _ = pair
    model = tf.init_params(cfg, 0, device="cpu")
    got = dict(jax.tree_util.tree_leaves_with_path(
        bridge.export_params(model)))
    want = jax.tree_util.tree_leaves_with_path(params)
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].shape == leaf.shape, path
    assert cfg.param_count() == sum(x.size for _, x in want)


def test_prefill_logits_and_latent_cache(pair):
    jcfg, cfg, params, _, model = pair
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32)
    want, jaux = jtf.forward(params, jcfg, {"tokens": jnp.asarray(tokens)},
                             policy=JPolicy.full(), build_cache=True)
    before = _launches()
    got, aux = tf.forward(model, cfg, {"tokens": torch.from_numpy(tokens)},
                          policy=Policy.full(), build_cache=True)
    assert _launches() == before
    assert _rel(got.numpy(), want) <= F32_TOL
    jc, c = jaux["cache"], aux["cache"]
    assert set(c) == set(jc) == {"pos", "mla_lat", "mla_rope"}
    assert int(c["pos"]) == int(jc["pos"]) == 24
    for name in ("mla_lat", "mla_rope"):
        assert c[name].dtype == torch.bfloat16
        assert c[name].shape == jc[name].shape
        assert _rel(c[name].float().numpy(),
                    np.asarray(jc[name], np.float32)) <= LAT_TOL


def test_init_and_grow_cache_match_jax(pair):
    jcfg, cfg, _, _, _ = pair
    jc = jtf.init_cache(jcfg, 3, 40)
    c = tf.init_cache(cfg, 3, 40, device="cpu")
    assert set(c) == set(jc)
    for name in ("mla_lat", "mla_rope"):
        assert tuple(c[name].shape) == jc[name].shape
        assert c[name].dtype == torch.bfloat16
    grown = tf.grow_cache({k: v[:, :, :10] if v.ndim else v
                           for k, v in c.items()}, 40)
    assert grown["mla_lat"].shape == c["mla_lat"].shape


def _runs(jcfg, cfg, params, model, steps, s_max):
    """Prefill a (2, 16) prompt, then ``steps`` lockstep greedy steps on
    both sides, each decoding its own greedy tokens."""
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32)
    jl, jaux = jtf.forward(params, jcfg, {"tokens": jnp.asarray(tokens)},
                           build_cache=True)
    tl, aux = tf.forward(model, cfg, {"tokens": torch.from_numpy(tokens)},
                         build_cache=True)
    jcache = jtf.grow_cache(jaux["cache"], s_max)
    cache = tf.grow_cache(aux["cache"], s_max)
    jdecode = jax.jit(lambda p, c, t: jtf.decode_step(p, jcfg, c, t))
    jt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    tt = tl[:, -1].argmax(-1).to(torch.int32)
    out = []
    for _ in range(steps):
        want, jcache = jdecode(params, jcache, jnp.asarray(jt))
        got, cache = tf.decode_step(model, cfg, cache, tt)
        out.append((np.asarray(want), got.numpy()))
        jt = np.asarray(want).argmax(-1).astype(np.int32)
        tt = got.argmax(-1).to(torch.int32)
    return out, jcache, cache


def test_lockstep_decode_matches_jax(pair):
    jcfg, cfg, params, _, model = pair
    before = _launches()
    steps, jcache, cache = _runs(jcfg, cfg, params, model, 8, 32)
    assert _launches() == before
    for want, got in steps:
        assert _rel(got, want) <= 1e-3          # after bf16 latent caches
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert int(cache["pos"]) == int(jcache["pos"]) == 24
    for name in ("mla_lat", "mla_rope"):
        assert _rel(cache[name].float().numpy(),
                    np.asarray(jcache[name], np.float32)) <= LAT_TOL


def test_per_slot_decode_refuses_mla(pair):
    _, cfg, _, _, model = pair
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    cache["pos"] = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="MLA"):
        tf.decode_step(model, cfg, cache, torch.zeros(2, dtype=torch.int32))


def test_loss_and_every_gradient_match_jax(pair):
    jcfg, cfg, params, tree, _ = pair
    model = bridge.load_jax_params(cfg, tree, device="cpu").requires_grad_()
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 25)).astype(np.int32)
    t, lab = toks[:, :-1].copy(), toks[:, 1:].copy()
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
    assert any("q_a" in str(p) for p in got)
    for path, g in got.items():
        assert _rel(g, want[path]) <= F32_TOL, path


def test_bf16_policy_logits(pair):
    jcfg, cfg, params, tree, _ = pair
    model = bridge.load_jax_params(cfg, tree, device="cpu",
                                   policy=Policy.bf16())
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab, (1, 16)).astype(np.int32)
    want, _ = jtf.forward(params, jcfg, {"tokens": jnp.asarray(tokens)},
                          policy=JPolicy.bf16())
    got, _ = tf.forward(model, cfg, {"tokens": torch.from_numpy(tokens)},
                        policy=Policy.bf16())
    # both round activations to bf16 after every product and norm, at
    # different points: a few bf16 ulps over 2 layers
    assert _rel(got.numpy(), want) <= 5e-2


# --------------------------------------------------------------------------
# Serving: lockstep only.
# --------------------------------------------------------------------------
def test_lockstep_driver_greedy_tokens_match_jax(pair):
    """``launch/serve.py``'s lockstep driver on bridged weights, policy
    full, greedy, against the same prefill and decode loop of the JAX
    package: token for token."""
    jcfg, cfg, params, _, model = pair
    args = argparse.Namespace(no_quantize=False, policy="full", seed=7,
                              batch=3, prompt_len=12, gen=10,
                              temperature=0.0, top_k=0, kv_splits=1)
    before = _launches()
    got = serve_cli.lockstep(args, cfg, model, torch.device("cpu"))
    assert _launches() == before
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    jl, jaux = jtf.forward(params, jcfg, {"tokens": jnp.asarray(prompts)},
                           build_cache=True)
    jcache = jtf.grow_cache(jaux["cache"], args.prompt_len + args.gen)
    tok = np.asarray(jl)[:, -1, :cfg.vocab].argmax(-1).astype(np.int32)
    want = [tok]
    for _ in range(args.gen - 1):
        logits, jcache = jtf.decode_step(params, jcfg, jcache,
                                         jnp.asarray(tok))
        tok = np.asarray(logits)[:, :cfg.vocab].argmax(-1).astype(np.int32)
        want.append(tok)
    np.testing.assert_array_equal(got["tokens"], np.stack(want, 1))


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)


def test_cli_serves_mla_in_lockstep_and_the_engine_refuses():
    out = _cli("--device", "cpu", "--smoke", "--arch", ARCH, "--gen", "12")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "MLA latent attention" in out.stdout
    assert "ms/tok" in out.stdout and "prefill 4x64" in out.stdout
    refused = _cli("--device", "cpu", "--smoke", "--arch", ARCH, "--engine")
    assert refused.returncode == 2
    assert "not engine-eligible" in refused.stdout and "MLA" in refused.stdout


def test_engine_refuses_mla(pair):
    _, cfg, _, _, model = pair
    assert not supports(cfg)
    with pytest.raises(NotImplementedError, match="MLA"):
        ServeEngine(model, cfg, max_slots=2, max_len=32)


# --------------------------------------------------------------------------
# The planner.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("b,s", [(2, 64), (1, 300)])
def test_planner_mla_profile_equals_jax(pair, b, s):
    jcfg, cfg, _, _, _ = pair
    assert not plan.flash_training_eligible(cfg, s)
    assert not jplan.flash_training_eligible(jcfg, s)
    for kw in ({}, {"dtype_bytes": 4}, {"dtype_bytes": 4,
                                         "flash_resid_bytes": 2}):
        jp = jplan.profile_transformer(
            jcfg, {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}, **kw)
        tp = plan.profile_transformer(
            cfg, {"tokens": torch.empty((b, s), dtype=torch.int32,
                                        device="meta")}, **kw)
        assert tp.act_bytes == jp.act_bytes
        assert tp.resid_bytes == jp.resid_bytes
        assert tp.flops == jp.flops
        assert tp.labels == jp.labels
    for ctx in (s, 16):
        assert plan.attn_resid_bytes(cfg, b, s, ctx=ctx) == \
            jplan.attn_resid_bytes(jcfg, b, s, ctx)
    # the latents are not the int8 KV layout: no kv or decode-tile report
    assert plan.kv_cache_report(cfg, b, s) == jplan.kv_cache_report(jcfg, b,
                                                                    s)
    assert not plan.kv_cache_report(cfg, b, s)["eligible"]
    assert not plan.decode_tile_report(cfg, b, s)["eligible"]
    assert not plan.flash_attn_flop_report(cfg, b, s)["eligible"]


def test_full_config_builds(pair):
    cfg = configs.get_config(ARCH)
    assert cfg.mla is not None and cfg.n_layers == 62
    assert configs.smoke_config(ARCH).mla.kv_lora_rank == 16
    assert dataclasses.replace(cfg, n_layers=2).param_count() < \
        cfg.param_count()
