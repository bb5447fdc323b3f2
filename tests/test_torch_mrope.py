"""qwen2-vl-2b (M-RoPE, a patch prefix, tied embeddings) in the port
against the JAX package, on the CPU, at smoke size (2 layers, sections
(4, 2, 2)), inputs from numpy with a seed: ``apply_rope`` over (3, B, S)
positions, ``attn_block`` (which never reaches the flash op under M-RoPE
or ``causal=False``), ``forward`` with patches, the loss and every
gradient (plain and chunked CE; the tied ``embed`` and ``patch_proj``
included), lockstep and per-slot decode, the engine's greedy tokens
against JAX's ``ServeEngine`` (``kv_backend="ref"``), AdamW steps through
``build_train_step`` with the batch split in microbatches, the planner's
profile, the bridge and a port checkpoint restored into JAX's tree.

M-RoPE with three equal streams is 1-D RoPE, so every check here uses
positions whose streams differ: a patch grid (t = 0, h = row, w = col),
then text continuing from the grid's largest position + 1.  Tolerances:
f32 on both sides, so summation order only (1e-5 on one block, 1e-4 on
logits, losses and gradients), 1e-3 on decode after int8 caches.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import plan as jplan
from repro.checkpointing.ckpt import CheckpointManager as JManager
from repro.core.mixed_precision import LossScale as JLossScale
from repro.core.mixed_precision import Policy as JPolicy
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.serve import ServeEngine as JServeEngine
from repro.serve import synthetic_trace as jsynthetic_trace
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import build_train_step as jbuild
from repro_torch import configs, plan
from repro_torch.checkpointing.ckpt import CheckpointManager
from repro_torch.core.mixed_precision import Policy, scaled_value_and_grad
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import train_state
from repro_torch.models import attention, bridge, layers
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.serve import ServeEngine, supports, synthetic_trace
from repro_torch.train.train_step import (TrainConfig, build_train_step,
                                          init_loss_scale)

torch.set_num_threads(2)
ARCH = "qwen2-vl-2b"
LOGIT_RTOL = 1e-4
BLOCK_TOL = 1e-5
DECODE_TOL = 1e-3
ROWS, COLS = 3, 4                  # the smoke tests' patch grid


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def grid_positions(b: int, s: int, rows: int = ROWS, cols: int = COLS):
    """(3, B, S) int32: a rows x cols patch grid (t = 0, h = row, w =
    col), then text on all three streams from the grid's largest position
    + 1."""
    sp = rows * cols
    i = np.arange(sp)
    grid = np.stack([np.zeros(sp), i // cols, i % cols])
    text = max(rows, cols) + np.arange(s - sp)
    pos = np.concatenate([grid, np.broadcast_to(text, (3, s - sp))], axis=1)
    return np.ascontiguousarray(
        np.broadcast_to(pos[:, None], (3, b, s)).astype(np.int32))


@pytest.fixture(scope="module")
def pair():
    # a flash backend on the JAX side: its M-RoPE gate must still send the
    # attention to the plain path
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH),
                               attn_backend="interpret")
    cfg = configs.smoke_config(ARCH)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(17))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, cfg, params, tree, bridge.load_jax_params(cfg, tree,
                                                          device="cpu")


def _batch(cfg, seed, b=2, s=24, labels=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1].copy(),
           "patches": rng.standard_normal(
               (b, ROWS * COLS, cfg.d_model)).astype(np.float32),
           "positions": grid_positions(b, s)}
    if labels:
        out["labels"] = toks[:, 1:].copy()
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# M-RoPE.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d,sections,theta", [(16, (4, 2, 2), 1e4),
                                              (128, (16, 24, 24), 1e6)])
@pytest.mark.parametrize("s", [1, 20])
def test_apply_rope_mrope_matches_jax(d, sections, theta, s):
    rng = np.random.default_rng(d + s)
    x = rng.standard_normal((2, s, 3, d)).astype(np.float32)
    # one token: a patch at row 1, column 2 (t, h, w = 0, 1, 2)
    pos = grid_positions(2, 20)[..., 6:7] if s == 1 else grid_positions(2, s)
    assert len({tuple(p.ravel()) for p in pos}) == 3     # streams differ
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                              mrope_sections=sections)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta, mrope_sections=sections)
    assert _rel(got.numpy(), want) <= BLOCK_TOL
    # not 1-D RoPE on any one stream
    for stream in range(3):
        one = layers.apply_rope(torch.from_numpy(x),
                                torch.from_numpy(pos[stream]), theta)
        assert _rel(one.numpy(), want) > 1e-3


def test_mrope_with_equal_streams_is_1d_rope():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 9, 3, 16)).astype(
        np.float32))
    pos = torch.arange(9).expand(2, 9)
    np.testing.assert_array_equal(
        layers.apply_rope(x, pos.expand(3, 2, 9), 1e4,
                          mrope_sections=(4, 2, 2)).numpy(),
        layers.apply_rope(x, pos, 1e4).numpy())


def test_mrope_sections_must_cover_the_rotary_half():
    x = torch.zeros((1, 4, 2, 16))
    with pytest.raises(AssertionError):
        layers.apply_rope(x, torch.zeros((3, 1, 4), dtype=torch.int32), 1e4,
                          mrope_sections=(4, 2, 1))


def test_attn_block_mrope_matches_jax(pair):
    jcfg, cfg, params, _, model = pair
    x = np.random.default_rng(2).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    pos = grid_positions(2, 24)
    p = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    want, (wk, _) = jattn.attn_block(p, jnp.asarray(x), jcfg,
                                     positions=jnp.asarray(pos))
    got, (k, _) = attention.attn_block(model.blocks[0].attn,
                                       torch.from_numpy(x), cfg,
                                       positions=torch.from_numpy(pos))
    assert _rel(got.numpy(), want) <= BLOCK_TOL
    assert _rel(k.numpy(), wk) <= BLOCK_TOL


def test_attn_block_takes_the_flash_op_only_where_the_reference_does(
        pair, monkeypatch):
    """Causal attention over 1-D positions reaches the flash op; M-RoPE's
    (3, B, S) positions and ``causal=False`` never do (the reference's gate,
    ``attention.py:122-124``)."""
    _, cfg, _, _, model = pair
    calls = []
    real = attention.flash_ops.flash_attention
    monkeypatch.setattr(attention.flash_ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    blk = model.blocks[0].attn
    x = torch.randn((2, 16, cfg.d_model))
    pos3 = torch.from_numpy(grid_positions(2, 16))
    attention.attn_block(blk, x, cfg, positions=pos3)
    attention.attn_block(blk, x, cfg, positions=pos3, causal=False)
    flat = dataclasses.replace(cfg, mrope_sections=None)
    attention.attn_block(blk, x, flat, positions=pos3[0], causal=False)
    assert calls == []
    attention.attn_block(blk, x, flat, positions=pos3[0])
    assert calls == [1]
    # and so a model forward under M-RoPE never does
    tf.forward(model, cfg, _torch(_batch(cfg, 3)))
    assert calls == [1]


# --------------------------------------------------------------------------
# The model.
# --------------------------------------------------------------------------
def test_forward_with_patches_and_positions(pair):
    jcfg, cfg, params, _, model = pair
    batch = _batch(cfg, 4)
    want, jaux = jtf.forward(params, jcfg, _jax(batch),
                             policy=JPolicy.full(), build_cache=True)
    got, aux = tf.forward(model, cfg, _torch(batch), policy=Policy.full(),
                          build_cache=True)
    live = slice(0, cfg.vocab)
    assert _rel(got.numpy()[..., live], np.asarray(want)[..., live]) \
        <= LOGIT_RTOL
    for name in ("k", "v"):
        diff = np.abs(aux["cache"][name].numpy().astype(np.int32)
                      - np.asarray(jaux["cache"][name]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    # the patches replace the prefix: the tokens there do not matter
    other = dict(batch, tokens=batch["tokens"].copy())
    other["tokens"][:, :ROWS * COLS] = 0
    again, _ = tf.forward(model, cfg, _torch(other), policy=Policy.full())
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_default_positions_are_the_three_broadcast_streams(pair):
    jcfg, cfg, params, _, model = pair
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 12))
    tokens = tokens.astype(np.int32)
    pos = np.broadcast_to(np.arange(12), (3, 2, 12)).astype(np.int32)
    got, _ = tf.forward(model, cfg, {"tokens": torch.from_numpy(tokens)})
    same, _ = tf.forward(model, cfg, {"tokens": torch.from_numpy(tokens),
                                      "positions": torch.from_numpy(pos)})
    np.testing.assert_array_equal(got.numpy(), same.numpy())
    want, _ = jtf.forward(params, jcfg, {"tokens": jnp.asarray(tokens)},
                          policy=JPolicy.full())
    assert _rel(got.numpy()[..., :cfg.vocab],
                np.asarray(want)[..., :cfg.vocab]) <= LOGIT_RTOL


@pytest.mark.parametrize("ce_chunk", [0, 8])
def test_loss_and_every_gradient_match_jax(pair, ce_chunk):
    jcfg, cfg, params, tree, _ = pair
    model = bridge.load_jax_params(cfg, tree, device="cpu").requires_grad_()
    batch = _batch(cfg, 6, labels=True)
    (jl, _), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, _jax(batch), policy=JPolicy.full(),
                              ce_chunk=ce_chunk), has_aux=True)(params)
    vg = scaled_value_and_grad(lambda m, b: tf.loss_fn(
        m, cfg, b, policy=Policy.full(), ce_chunk=ce_chunk))
    (loss, _), grads, finite = vg(model, _torch(batch))
    assert bool(finite)
    assert abs(float(loss) - float(jl)) <= LOGIT_RTOL * abs(float(jl))
    got = dict(jax.tree_util.tree_leaves_with_path(bridge.to_jax_tree(grads)))
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jgrads)))
    assert got.keys() == want.keys()
    names = {jax.tree_util.keystr(p) for p in got}
    assert {"['embed']", "['patch_proj']"} <= names
    assert "['lm_head']" not in names
    for path, g in got.items():
        assert _rel(g, want[path]) <= LOGIT_RTOL, path


def test_chunked_ce_tied_embeddings(pair):
    """The port's ``tests/test_perf_variants.py::test_chunked_ce_tied_
    embeddings``: the plain and the chunked CE of the tied head give one
    loss."""
    _, cfg, _, _, model = pair
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy()),
             "positions": torch.arange(32).expand(3, 2, 32)}
    l1, _ = tf.loss_fn(model, cfg, batch)
    l2, _ = tf.loss_fn(model, cfg, batch, ce_chunk=16)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)


def _prefill(jcfg, cfg, params, model, b, s, s_max):
    batch = _batch(cfg, 8, b=b, s=s)
    _, jaux = jtf.forward(params, jcfg, _jax(batch), policy=JPolicy.full(),
                          build_cache=True)
    _, aux = tf.forward(model, cfg, _torch(batch), policy=Policy.full(),
                        build_cache=True)
    jcache = jtf.grow_cache(jaux["cache"], s_max)
    cache = tf.grow_cache(aux["cache"], s_max)
    for name in ("k", "v", "k_scale", "v_scale"):     # JAX's as reference
        cache[name] = torch.from_numpy(np.array(jcache[name]))
    return jcache, cache


def test_lockstep_decode_matches_jax(pair):
    jcfg, cfg, params, _, model = pair
    jcache, cache = _prefill(jcfg, cfg, params, model, 2, 20, 32)
    jdecode = jax.jit(lambda p, c, t: jtf.decode_step(
        p, jcfg, c, t, policy=JPolicy.full()))
    rng = np.random.default_rng(9)
    for _ in range(6):
        toks = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
        want, jcache = jdecode(params, jcache, jnp.asarray(toks))
        got, cache = tf.decode_step(model, cfg, cache, torch.from_numpy(toks),
                                    policy=Policy.full())
        assert _rel(got.numpy()[:, :cfg.vocab],
                    np.asarray(want)[:, :cfg.vocab]) <= DECODE_TOL
    assert int(cache["pos"]) == int(jcache["pos"]) == 26


def test_per_slot_decode_matches_jax(pair):
    jcfg, cfg, params, _, model = pair
    jcache, cache = _prefill(jcfg, cfg, params, model, 3, 16, 32)
    pos = np.asarray([16, 13, 12], np.int32)
    jcache["pos"] = jnp.asarray(pos)
    cache["pos"] = torch.from_numpy(pos.copy())
    jdecode = jax.jit(lambda p, c, t, a: jtf.decode_step(
        p, jcfg, c, t, policy=JPolicy.full(), active=a))
    rng = np.random.default_rng(10)
    for step in range(6):
        toks = rng.integers(0, cfg.vocab, (3,)).astype(np.int32)
        active = np.asarray([True, step % 2 == 0, step < 4])
        want, jcache = jdecode(params, jcache, jnp.asarray(toks),
                               jnp.asarray(active))
        got, cache = tf.decode_step(model, cfg, cache, torch.from_numpy(toks),
                                    policy=Policy.full(),
                                    active=torch.from_numpy(active))
        assert _rel(got.numpy()[:, :cfg.vocab],
                    np.asarray(want)[:, :cfg.vocab]) <= DECODE_TOL
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))


def test_engine_greedy_tokens_match_jax_engine(pair):
    jcfg, cfg, params, _, model = pair
    assert supports(cfg)
    kw = dict(max_slots=4, max_len=64, policy_name="full")
    trace_kw = dict(vocab=cfg.vocab, mean_prompt=12, max_prompt=32,
                    mean_gen=8, max_gen=24)
    jeng = JServeEngine(params, jcfg, kv_backend="ref", **kw)
    jsum = jeng.run(jsynthetic_trace(8, seed=4, **trace_kw))
    eng = ServeEngine(model, cfg, **kw)
    summ = eng.run(synthetic_trace(8, seed=4, **trace_kw))
    assert summ["n_done"] == jsum["n_done"] == 8
    assert {r.rid: r.tokens for r in eng._requests_done} == \
        {r.rid: r.tokens for r in jeng._requests_done}
    assert eng.pool.occupancy == 0 and eng.pool.allocs == eng.pool.frees


# --------------------------------------------------------------------------
# Training.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(pair, accum):
    """AdamW steps through ``build_train_step``, f32, with patches and
    3-stream positions split into microbatches: the tied embedding takes
    its gradient from the lookup and the head, and weight decay by its
    JAX-layout rank, as in JAX."""
    jcfg, cfg, params, tree, _ = pair
    opt_kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jbuild(jcfg, JTrainConfig(
        policy="full", accum=accum, opt=jadamw.AdamWConfig(**opt_kw))))
    tc = TrainConfig(policy="full", accum=accum,
                     opt=adamw.AdamWConfig(**opt_kw))
    step = build_train_step(cfg, tc)
    model = bridge.load_jax_params(cfg, tree, device="cpu").requires_grad_()
    opt = adamw.init(dict(model.named_parameters()))
    ls = init_loss_scale(tc, "cpu")
    jparams, jopt, jls = params, jadamw.init(params), JLossScale.noop()
    for i in range(2):
        batch = _batch(cfg, 20 + i, labels=True)
        jparams, jopt, jls, jm = jstep(jparams, jopt, jls, _jax(batch))
        model, opt, ls, m = step(model, opt, ls, _torch(batch))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jparams)))
    got = dict(jax.tree_util.tree_leaves_with_path(
        bridge.export_params(model)))
    start = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert got.keys() == want.keys()
    for path, w in want.items():        # the update each package applied
        dw, dg = w - start[path], got[path] - start[path]
        assert np.linalg.norm(dg - dw) <= 1e-3 * np.linalg.norm(dw), path


def test_train_cli_trains_text_only(tmp_path, capsys):
    assert train_cli.main(["--device", "cpu", "--smoke", "--arch", ARCH,
                           "--steps", "2", "--batch", "2", "--seq", "16",
                           "--ckpt-dir", str(tmp_path), "--fresh"]) == 0
    assert "step     1 loss" in capsys.readouterr().out


def test_planner_profile_equals_jax(pair):
    jcfg, cfg, _, _, _ = pair
    for b, s in ((2, 64), (1, 300)):
        assert not plan.flash_training_eligible(cfg, s)
        assert not jplan.flash_training_eligible(jcfg, s)
        for kw in ({}, {"dtype_bytes": 4}):
            jp = jplan.profile_transformer(
                jcfg, {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)},
                **kw)
            tp = plan.profile_transformer(
                cfg, {"tokens": torch.empty((b, s), dtype=torch.int32,
                                            device="meta")}, **kw)
            assert tp.act_bytes == jp.act_bytes
            assert tp.resid_bytes == jp.resid_bytes
            assert tp.flops == jp.flops
            assert tp.labels == jp.labels
        assert plan.attn_resid_bytes(cfg, b, s, ctx=s) == \
            jplan.attn_resid_bytes(jcfg, b, s, s)
        assert not plan.flash_attn_flop_report(cfg, b, s)["eligible"]


# --------------------------------------------------------------------------
# Layout.
# --------------------------------------------------------------------------
def test_bridge_round_trip_bit_exact(pair):
    _, _, _, tree, model = pair
    back = bridge.export_params(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    assert "lm_head" not in back and back["patch_proj"].shape == (64, 64)


def test_port_checkpoint_restores_into_the_jax_tree(tmp_path):
    cfg, jcfg = configs.smoke_config(ARCH), jconfigs.smoke_config(ARCH)
    model, opt = train_cli.init_state(cfg, 2, "cpu")
    CheckpointManager(str(tmp_path)).save(4, train_state(model, opt),
                                          extra={"step": 4}, config=ARCH)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    state, _ = JManager(str(tmp_path)).restore(
        4, {"params": jparams, "opt": jadamw.init(jparams)}, config=ARCH)
    want = dict(jax.tree_util.tree_leaves_with_path(
        bridge.export_params(model)))
    got = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, state["params"])))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf)


def test_full_config():
    cfg = configs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
            cfg.d_ff) == (28, 1536, 12, 2, 128, 8960)
    assert cfg.mrope_sections == (16, 24, 24) and cfg.tie_embeddings
    assert sum(cfg.mrope_sections) == cfg.head_dim // 2
    model = tf.init_params(cfg, 0, device="meta")
    # the analytic count leaves out patch_proj and the padded rows
    extra = cfg.d_model ** 2 + (cfg.padded_vocab - cfg.vocab) * cfg.d_model
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + extra
    assert abs(cfg.param_count() - 1.54e9) < 0.01e9
