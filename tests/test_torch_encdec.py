"""whisper-base (the encoder-decoder) in the port against the JAX package,
on the CPU, at smoke size (2 + 2 layers, 32 frames), inputs from numpy
with a seed: ``gelu_mlp``, ``cross_attn_block``, ``attn_block(causal=
False)``, the encoder, ``forward`` with frames (logits and int8 cache),
decode steps with ``enc_out`` (quantized and not), the loss and every
gradient (plain and chunked CE), the bridge round trip, a port checkpoint
restored into JAX's tree, the planner's profile, the lockstep CLI's tokens
against the reference CLI's at zero frames, and the refusals (engine, train
CLI).

The JAX decoder's self-attention takes its Pallas flash kernel in
interpret mode (``attn_backend="interpret"``), the reference's path for
causal attention; the encoder and the cross-attention are plain einsums
in both packages.  Tolerances: f32 on both sides, so summation order only
(1e-4 relative on logits, losses and gradients, 1e-5 on one block), 1e-3
on decode after int8 caches that may differ by one step at a .5.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import plan as jplan
from repro.checkpointing.ckpt import CheckpointManager as JManager
from repro.core.mixed_precision import Policy as JPolicy
from repro.launch import serve as jserve_cli
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch import configs, plan
from repro_torch.checkpointing.ckpt import CheckpointManager
from repro_torch.core.mixed_precision import Policy, scaled_value_and_grad
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import train_state
from repro_torch.models import attention, bridge, layers
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.serve import ServeEngine, supports

torch.set_num_threads(2)
ARCH = "whisper-base"
LOGIT_RTOL = 1e-4
BLOCK_TOL = 1e-5
DECODE_TOL = 1e-3


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def _int8_close(got, want, frac=1e-3):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= frac


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH),
                               attn_backend="interpret")
    cfg = configs.smoke_config(ARCH)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(21))
    # the reference starts its biases at zero; random ones show that both
    # packages add them where they belong
    rng = np.random.default_rng(21)
    for tree in (params["blocks"]["ffn"], params["enc_blocks"]["ffn"]):
        for name in ("b1", "b2"):
            tree[name] = jnp.asarray(0.1 * rng.standard_normal(
                tree[name].shape).astype(np.float32))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, cfg, params, tree, bridge.load_jax_params(cfg, tree,
                                                          device="cpu")


def _inputs(cfg, seed, b=2, s=20):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    frames = rng.standard_normal(
        (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return tokens, frames


# --------------------------------------------------------------------------
# The pieces.
# --------------------------------------------------------------------------
def test_gelu_mlp_matches_jax():
    rng = np.random.default_rng(0)
    x, w1, b1, w2, b2 = (rng.standard_normal(s).astype(np.float32)
                         for s in ((3, 5, 16), (16, 48), (48,), (48, 16),
                                   (16,)))
    want = jlayers.gelu_mlp(*map(jnp.asarray, (x, w1, b1, w2, b2)))
    got = layers.gelu_mlp(*map(torch.from_numpy, (x, w1, b1, w2, b2)))
    assert _rel(got.numpy(), want) <= BLOCK_TOL


@pytest.mark.parametrize("s,se", [(1, 32), (7, 32), (20, 5)])
def test_cross_attn_block_matches_jax(pair, s, se):
    jcfg, cfg, params, _, model = pair
    rng = np.random.default_rng(s + se)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((2, se, cfg.n_kv, cfg.head_dim))
          .astype(np.float32) for _ in range(2)]
    p = jax.tree.map(lambda a: a[0], params["blocks"]["xattn"])
    want = jattn.cross_attn_block(p, jnp.asarray(x),
                                  tuple(map(jnp.asarray, kv)), jcfg)
    got = attention.cross_attn_block(model.blocks[0].xattn,
                                     torch.from_numpy(x),
                                     tuple(map(torch.from_numpy, kv)), cfg)
    assert _rel(got.numpy(), want) <= BLOCK_TOL


def test_attn_block_noncausal_matches_jax(pair):
    jcfg, cfg, params, _, model = pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24)[None], (2, 24)).astype(np.int32)
    p = jax.tree.map(lambda a: a[1], params["enc_blocks"]["attn"])
    want, (wk, _) = jattn.attn_block(p, jnp.asarray(x), jcfg,
                                     positions=jnp.asarray(pos), causal=False)
    got, (k, _) = attention.attn_block(
        model.enc_blocks[1].attn, torch.from_numpy(x), cfg,
        positions=torch.from_numpy(pos), causal=False)
    assert _rel(got.numpy(), want) <= BLOCK_TOL
    assert _rel(k.numpy(), wk) <= BLOCK_TOL


def test_encoder_matches_jax(pair):
    jcfg, cfg, params, _, model = pair
    _, frames = _inputs(cfg, 4)
    want = jtf._run_encoder(params, jcfg, jnp.asarray(frames),
                            JPolicy.full())
    got = tf.run_encoder(model, cfg, torch.from_numpy(frames), Policy.full())
    assert _rel(got.numpy(), want) <= BLOCK_TOL


def test_forward_with_frames_logits_and_cache(pair):
    jcfg, cfg, params, _, model = pair
    tokens, frames = _inputs(cfg, 5)
    want, jaux = jtf.forward(params, jcfg, {"tokens": jnp.asarray(tokens),
                                            "frames": jnp.asarray(frames)},
                             policy=JPolicy.full(), build_cache=True)
    got, aux = tf.forward(model, cfg, {"tokens": torch.from_numpy(tokens),
                                       "frames": torch.from_numpy(frames)},
                          policy=Policy.full(), build_cache=True)
    live = slice(0, cfg.vocab)
    assert got.shape == want.shape
    assert _rel(got.numpy()[..., live], np.asarray(want)[..., live]) \
        <= LOGIT_RTOL
    assert aux["enc_out"].shape == (2, cfg.encoder.n_frames, cfg.d_model)
    jc, c = jaux["cache"], aux["cache"]
    assert int(c["pos"]) == int(jc["pos"]) == tokens.shape[1]
    for name in ("k", "v"):
        _int8_close(c[name].numpy(), np.asarray(jc[name]))


@pytest.mark.parametrize("quantized", [True, False])
def test_decode_with_enc_out_matches_jax(pair, quantized):
    jcfg, cfg, params, _, model = pair
    tokens, frames = _inputs(cfg, 6, s=8)
    jl, jaux = jtf.forward(params, jcfg, {"tokens": jnp.asarray(tokens),
                                          "frames": jnp.asarray(frames)},
                           policy=JPolicy.full(), build_cache=True,
                           cache_quantized=quantized)
    _, aux = tf.forward(model, cfg, {"tokens": torch.from_numpy(tokens),
                                     "frames": torch.from_numpy(frames)},
                        policy=Policy.full(), build_cache=True,
                        cache_quantized=quantized)
    enc_out = aux["enc_out"]
    jenc = jtf._run_encoder(params, jcfg, jnp.asarray(frames),
                            JPolicy.full())
    jcache = jtf.grow_cache(jaux["cache"], 24)
    cache = tf.grow_cache(aux["cache"], 24)
    # the JAX entries are the reference: start both from them
    for name in ("k", "v", "k_scale", "v_scale"):
        cache[name] = torch.from_numpy(np.array(
            jcache[name], np.int8 if quantized and name in ("k", "v")
            else np.float32)).to(cache[name].dtype)
    jdecode = jax.jit(lambda p, c, t, e: jtf.decode_step(
        p, jcfg, c, t, policy=JPolicy.full(), quantized=quantized,
        enc_out=e))
    rng = np.random.default_rng(7)
    for _ in range(6):
        toks = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
        want, jcache = jdecode(params, jcache, jnp.asarray(toks), jenc)
        got, cache = tf.decode_step(model, cfg, cache, torch.from_numpy(toks),
                                    policy=Policy.full(), quantized=quantized,
                                    enc_out=enc_out)
        live = slice(0, cfg.vocab)
        assert _rel(got.numpy()[:, live], np.asarray(want)[:, live]) \
            <= DECODE_TOL
    assert int(cache["pos"]) == int(jcache["pos"]) == 14


def test_decode_needs_enc_out_exactly_for_an_encoder(pair):
    _, cfg, _, _, model = pair
    cache = tf.init_cache(cfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="enc_out"):
        tf.decode_step(model, cfg, cache, torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("ce_chunk", [0, 8])
def test_loss_and_every_gradient_match_jax(pair, ce_chunk):
    jcfg, cfg, params, tree, _ = pair
    model = bridge.load_jax_params(cfg, tree, device="cpu").requires_grad_()
    toks, frames = _inputs(cfg, 8, s=21)
    t, lab = toks[:, :-1].copy(), toks[:, 1:].copy()
    jb = {"tokens": jnp.asarray(t), "labels": jnp.asarray(lab),
          "frames": jnp.asarray(frames)}
    (jl, _), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, jb, policy=JPolicy.full(),
                              ce_chunk=ce_chunk), has_aux=True)(params)
    vg = scaled_value_and_grad(lambda m, b: tf.loss_fn(
        m, cfg, b, policy=Policy.full(), ce_chunk=ce_chunk))
    (loss, _), grads, finite = vg(model, {
        "tokens": torch.from_numpy(t), "labels": torch.from_numpy(lab),
        "frames": torch.from_numpy(frames)})
    assert bool(finite)
    assert abs(float(loss) - float(jl)) <= LOGIT_RTOL * abs(float(jl))
    got = dict(jax.tree_util.tree_leaves_with_path(bridge.to_jax_tree(grads)))
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jgrads)))
    assert got.keys() == want.keys()
    names = " ".join(jax.tree_util.keystr(p) for p in got)
    for leaf in ("enc_blocks", "enc_norm", "xattn", "ln_x", "'b1'", "'b2'"):
        assert leaf in names
    for path, g in got.items():
        assert _rel(g, want[path]) <= LOGIT_RTOL, path


def test_adamw_decays_encoder_leaves_by_the_jax_rank(pair):
    _, _, params, _, model = pair
    named = dict(model.named_parameters())
    mask = adamw.jax_layout_decay_mask(named)
    assert mask["enc_blocks.0.ffn.b1"] and mask["blocks.1.ln_x"]
    assert not mask["enc_norm"] and not mask["final_norm"]
    # the JAX rule (adamw.py:77) on the JAX tree, leaf by port name
    want = bridge.from_jax_tree(jax.tree.map(
        lambda p: np.full(p.shape, np.ndim(p) >= 2), params))
    assert mask == {n: bool(a.flat[0]) for n, a in want.items()}


# --------------------------------------------------------------------------
# Layout: the bridge, checkpoints, the planner.
# --------------------------------------------------------------------------
def test_bridge_round_trip_bit_exact(pair):
    _, _, _, tree, model = pair
    back = bridge.export_params(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    assert "lm_head" in back and "patch_proj" not in back


def test_init_params_matches_jax_shapes(pair):
    jcfg, cfg, params, _, _ = pair
    mine = bridge.export_params(tf.init_params(cfg, 3, device="cpu"))
    want = {jax.tree_util.keystr(p): np.shape(x)
            for p, x in jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(p): np.shape(x)
           for p, x in jax.tree_util.tree_leaves_with_path(mine)}
    assert got == want
    # the biases start at zero, as the reference's
    assert not mine["blocks"]["ffn"]["b1"].any()
    assert not mine["enc_blocks"]["ffn"]["b2"].any()


def test_port_checkpoint_restores_into_the_jax_tree(tmp_path):
    cfg = configs.smoke_config(ARCH)
    jcfg = jconfigs.smoke_config(ARCH)
    model, opt = train_cli.init_state(cfg, 5, "cpu")
    for name, p in model.named_parameters():
        opt.mu[name].fill_(0.5)
    CheckpointManager(str(tmp_path)).save(3, train_state(model, opt),
                                          extra={"step": 3}, config=ARCH)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    like = {"params": jparams, "opt": jadamw.init(jparams)}
    state, extra = JManager(str(tmp_path)).restore(3, like, config=ARCH)
    assert extra == {"step": 3}
    want = dict(jax.tree_util.tree_leaves_with_path(
        bridge.export_params(model)))
    got = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, state["params"])))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf)
    assert all(np.all(np.asarray(m) == 0.5)
               for m in jax.tree_util.tree_leaves(state["opt"].mu))


@pytest.mark.parametrize("b,s", [(1, 128), (2, 256)])
def test_planner_profile_equals_jax(pair, b, s, monkeypatch):
    jcfg, cfg, _, _, _ = pair
    # the port's planner at the TPU kernels' 128 x 128 tiles (the seam
    # tests/test_torch_plan.py uses): the flash grids' FLOPs then agree
    monkeypatch.setattr(flash_ops, "BQ", 128)
    monkeypatch.setattr(flash_ops, "BK", 128)
    assert plan.flash_training_eligible(cfg, s)
    assert jplan.flash_training_eligible(jcfg, s)
    for kw in ({}, {"dtype_bytes": 4}):
        jp = jplan.profile_transformer(
            jcfg, {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}, **kw)
        tp = plan.profile_transformer(
            cfg, {"tokens": torch.empty((b, s), dtype=torch.int32,
                                        device="meta")}, **kw)
        assert tp.act_bytes == jp.act_bytes
        assert tp.resid_bytes == jp.resid_bytes
        assert tp.flops == jp.flops
        assert tp.labels == jp.labels


# --------------------------------------------------------------------------
# The CLIs.
# --------------------------------------------------------------------------
def _lockstep_args(**kw):
    return argparse.Namespace(**{
        **dict(no_quantize=False, policy="full", seed=9, batch=3,
               prompt_len=10, gen=12, temperature=0.0, top_k=0, kv_splits=1,
               kv_backend="ref"), **kw})


def test_lockstep_cli_tokens_equal_the_reference_cli_at_zero_frames(
        pair, capsys):
    """The reference CLI hands the raw frames to the decode steps as
    ``enc_out``; the port hands the encoder's output.  At zero frames the
    two agree (zero input, zero biases, and RMSNorm of zero is zero), so
    the two CLIs' greedy tokens are equal."""
    jcfg, cfg, params, tree, _ = pair
    # the reference's init: zero biases
    zero = {**tree, "blocks": {**tree["blocks"], "ffn": {
        **tree["blocks"]["ffn"], "b1": 0 * tree["blocks"]["ffn"]["b1"],
        "b2": 0 * tree["blocks"]["ffn"]["b2"]}},
        "enc_blocks": {**tree["enc_blocks"], "ffn": {
            **tree["enc_blocks"]["ffn"],
            "b1": 0 * tree["enc_blocks"]["ffn"]["b1"],
            "b2": 0 * tree["enc_blocks"]["ffn"]["b2"]}}}
    model = bridge.load_jax_params(cfg, zero, device="cpu")
    args = _lockstep_args()
    got = serve_cli.lockstep(args, cfg, model, torch.device("cpu"))
    enc = tf.run_encoder(model, cfg, torch.zeros(
        (args.batch, cfg.encoder.n_frames, cfg.d_model)))
    assert not enc.any()
    jparams = jax.tree.map(jnp.asarray, zero)
    capsys.readouterr()
    assert jserve_cli.run_lockstep(args, jcfg, jparams) == 0
    sample = re.search(r"sample: (\[.*\])", capsys.readouterr().out)
    assert got["tokens"][0][:12].tolist() == ast.literal_eval(
        sample.group(1))
    assert got["tokens"].shape == (args.batch, args.gen)


def test_lockstep_takes_frames_and_runs_the_encoder_once(pair, monkeypatch):
    _, cfg, _, _, model = pair
    calls = []
    real = tf.run_encoder
    monkeypatch.setattr(tf, "run_encoder",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    args = _lockstep_args(gen=5)
    frames = torch.from_numpy(_inputs(cfg, 10, b=3)[1])
    got = serve_cli.lockstep(args, cfg, model, torch.device("cpu"),
                             frames=frames)
    assert len(calls) == 1
    # the same tokens as the model's own greedy decode over that encoder
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (3, args.prompt_len)).astype(np.int32)
    logits, aux = tf.forward(model, cfg, {"tokens": torch.from_numpy(prompts),
                                          "frames": frames},
                             build_cache=True)
    cache = tf.grow_cache(aux["cache"], args.prompt_len + args.gen)
    tok = logits[:, -1, :cfg.vocab].argmax(-1)
    want = [tok.numpy()]
    for _ in range(args.gen - 1):
        logits, cache = tf.decode_step(model, cfg, cache, tok,
                                       enc_out=aux["enc_out"])
        tok = logits[:, :cfg.vocab].argmax(-1)
        want.append(tok.numpy())
    np.testing.assert_array_equal(got["tokens"], np.stack(want, 1))


def test_train_cli_refuses_the_encoder_arch(capsys):
    assert train_cli.main(["--device", "cpu", "--smoke", "--arch", ARCH,
                           "--steps", "1", "--ckpt-dir", "unused"]) == 2
    assert "frames" in capsys.readouterr().err


def test_engine_refuses_the_encoder_arch(pair):
    _, cfg, _, _, model = pair
    assert not supports(cfg)
    with pytest.raises(NotImplementedError, match="encoder"):
        ServeEngine(model, cfg, max_slots=2, max_len=32)


def test_full_config():
    cfg = configs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff) == \
        (6, 512, 8, 8, 2048)
    assert cfg.padded_vocab == 51968 and cfg.mlp_kind == "gelu"
    assert cfg.encoder.n_layers == 6 and cfg.encoder.n_frames == 1500
    model = tf.init_params(cfg, 0, device="meta")
    d = cfg.d_model
    # the analytic count leaves out the GELU biases and the padded rows
    extra = (cfg.n_layers + cfg.encoder.n_layers) * (cfg.d_ff + d) \
        + 2 * (cfg.padded_vocab - cfg.vocab) * d
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + extra
