"""The port's training path on the CPU against the JAX package, at smoke
size, from the same weights (``bridge.load_jax_params``) and the same
numpy token batches: three AdamW steps of ``build_train_step`` under the
``full``, ``bf16`` and ``resid_bf16`` policies against the JAX step with
both of its attention paths, sequential checkpointing in every form the
port takes, the selective remat policies (``dots``, ``dots_nobatch``,
``save_names``) and the chunked CE against JAX under the same settings,
the memory planner's ``resolve_remat`` / ``make_train_step``, the
bf16-cotangent RMSNorm, AdamW, loss scaling, accumulation, and the
``launch/train.py`` CLI with resume.

Tolerances, each with its reason:
  * f32 (``full``, ``resid_bf16``): 1e-4 abs on losses and on the final
    parameters -- two f32 implementations that sum in different orders;
    1e-4 abs on the grad norm under ``full``, 1e-4 rel under
    ``resid_bf16``, whose saved forward output is rounded to bf16 and a
    last-digit difference there can flip one rounding (measured 1.1e-5
    rel);
  * ``bf16``: 1e-3 rel on losses.  XLA fuses elementwise chains and
    rounds to bf16 once per fusion where PyTorch rounds after every op,
    so bf16 gradients differ by a few ulps; the JAX package's own two
    attention paths (interpret vs jnp) differ by up to 1.8e-3 rel in the
    grad norm on these batches, so the grad norm is held to 5e-3 rel, and
    the final parameters to 2 x steps x lr abs (AdamW moves a
    near-zero-gradient weight by about lr per step in a direction that
    rounding can flip);
  * remat forms against each other: 1e-6 (the same arithmetic, rerun;
    relative for the selective policies);
  * selective policies against JAX under the same policy: 1e-4 abs on
    the loss and every gradient (f32);
  * the chunked CE against JAX's chunked CE and the port's unchunked
    one: 1e-5 abs (f32 sums in another order).
"""
from __future__ import annotations

import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.core.checkpoint import CheckpointConfig as JCheckpointConfig
from repro.core.mixed_precision import LossScale as JLossScale
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.plan import RematPlan as JRematPlan
from repro.train.train_step import build_train_step as jbuild
from repro.train.train_step import resolve_remat as jresolve
from repro_torch import configs
from repro_torch.core import api
from repro_torch.core.checkpoint import (CheckpointConfig,
                                         checkpoint_sequential, remat_scan)
from repro_torch.core.mixed_precision import (LossScale, all_finite,
                                              scaled_value_and_grad)
from repro_torch.kernels.flash import ref as flash_ref
from repro_torch.models import bridge, layers
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.plan import RematPlan
from repro_torch.train.train_step import (TrainConfig, build_train_step,
                                          init_loss_scale, make_train_step,
                                          microbatch_specs, resolve_remat)

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS, LR = 3, 1e-3
OPT = dict(lr=LR, warmup_steps=2, total_steps=10)


def _batches(vocab, n, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
        out.append((toks[:, :-1].copy(), toks[:, 1:].copy()))
    return out


def _jax_batch(t, lab):
    return {"tokens": jnp.asarray(t), "labels": jnp.asarray(lab)}


def _torch_batch(t, lab):
    return {"tokens": torch.from_numpy(t), "labels": torch.from_numpy(lab)}


@pytest.fixture(scope="module")
def smoke():
    jcfg = jconfigs.smoke_config("llama3-8b")
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, configs.smoke_config("llama3-8b"), params, \
        jax.tree.map(np.asarray, params)


def _port_state(cfg, tree):
    model = bridge.load_jax_params(cfg, tree, device="cpu").requires_grad_()
    return model, adamw.init(dict(model.named_parameters()))


@pytest.mark.parametrize("policy,backend,accum", [
    ("full", "interpret", 1), ("full", "jnp", 1), ("bf16", "interpret", 1),
    ("bf16", "jnp", 1), ("resid_bf16", "interpret", 1),
    ("full", "interpret", 2)])
def test_train_steps_match_jax(smoke, policy, backend, accum):
    jcfg, cfg, params, tree = smoke
    jcfg = dataclasses.replace(jcfg, attn_backend=backend)
    jstep = jax.jit(jbuild(jcfg, JTrainConfig(
        policy=policy, accum=accum, opt=jadamw.AdamWConfig(**OPT))))
    tc = TrainConfig(policy=policy, accum=accum,
                     opt=adamw.AdamWConfig(**OPT))
    step = build_train_step(cfg, tc)
    model, opt = _port_state(cfg, tree)
    ls = init_loss_scale(tc, "cpu")
    jopt, jls = jadamw.init(params), JLossScale.noop()
    for t, lab in _batches(cfg.vocab, STEPS):
        params, jopt, jls, jm = jstep(params, jopt, jls, _jax_batch(t, lab))
        model, opt, ls, m = step(model, opt, ls, _torch_batch(t, lab))
        assert bool(m["grads_finite"])
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        if policy == "bf16":
            assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                     rel=1e-3)
            assert float(m["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=5e-3)
        else:
            assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4
            gn_tol = 1e-4 * (float(jm["grad_norm"])
                             if policy == "resid_bf16" else 1.0)
            assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) \
                <= gn_tol
    assert int(opt.count) == int(jopt.count) == STEPS
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, params)))
    got = dict(jax.tree_util.tree_leaves_with_path(
        bridge.export_params(model)))
    start = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert want.keys() == got.keys()
    # the update each package applied, so that a missing or reversed one
    # fails (rel 1 or 2).  bf16: Adam divides each gradient by its own
    # scale, so bf16 rounding in a small gradient moves its update by up
    # to lr; measured over all leaves 0.059, worst leaf 0.142 (embed, whose
    # unseen rows have only tiny gradients), others <= 0.056.  The other
    # policies: <= 3.3e-4 per leaf.
    leaf_tol, all_tol = (0.25, 0.1) if policy == "bf16" else (1e-3, 1e-3)
    num = den = 0.0
    for path, w in want.items():
        dw, dg = w - start[path], got[path] - start[path]
        err, ref = np.linalg.norm(dg - dw), np.linalg.norm(dw)
        assert err <= leaf_tol * ref, path
        num, den = num + err ** 2, den + ref ** 2
        if policy != "bf16":
            assert np.abs(got[path] - w).max() <= 1e-4, path
    assert math.sqrt(num / den) <= all_tol


# --------------------------------------------------------------------------
# Sequential checkpointing.
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def deep():
    """A 4-layer smoke model, so segments of 2 and plans have room."""
    cfg = dataclasses.replace(configs.smoke_config("llama3-8b"), n_layers=4)
    model = tf.init_params(cfg, 3, device="cpu").requires_grad_()
    (t, lab), = _batches(cfg.vocab, 1, seed=3)
    return cfg, model, _torch_batch(t, lab)


REMATS = {
    "off": CheckpointConfig(enabled=False),
    "per_block": CheckpointConfig(),
    "segment_2": CheckpointConfig(segment_size=2),
    "plan": CheckpointConfig(plan=RematPlan(4, (1, 3), ("full", "none",
                                                         "nothing"))),
    "policy_none": CheckpointConfig(policy="none"),
}
# flash forwards per step: once per layer, again for every recomputed layer
FWD_CALLS = {"off": 4, "per_block": 8, "segment_2": 8, "plan": 6,
             "policy_none": 4}


def _loss_and_grads(cfg, model, batch, remat):
    vg = scaled_value_and_grad(lambda m, b: tf.loss_fn(m, cfg, b,
                                                       remat=remat))
    (loss, _), grads, finite = vg(model, batch)
    return loss, grads, finite


@pytest.mark.parametrize("name", sorted(REMATS))
def test_remat_forms_agree(deep, monkeypatch, name):
    cfg, model, batch = deep
    loss0, grads0, _ = _loss_and_grads(cfg, model, batch, REMATS["off"])
    calls = []
    real = flash_ref.flash_fwd_ref
    monkeypatch.setattr(flash_ref, "flash_fwd_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loss, grads, finite = _loss_and_grads(cfg, model, batch, REMATS[name])
    assert bool(finite)
    assert abs(float(loss) - float(loss0)) <= 1e-6
    for n, g in grads.items():
        assert float((g - grads0[n]).abs().max()) <= 1e-6, n
    assert len(calls) == FWD_CALLS[name]


def test_indivisible_segment_size_falls_back_with_warning(deep):
    cfg, model, batch = deep
    loss0, grads0, _ = _loss_and_grads(cfg, model, batch, REMATS["off"])
    with pytest.warns(UserWarning, match="largest divisor 2"):
        loss, grads, _ = _loss_and_grads(
            cfg, model, batch, CheckpointConfig(segment_size=3))
    assert abs(float(loss) - float(loss0)) <= 1e-6
    assert all(float((g - grads0[n]).abs().max()) <= 1e-6
               for n, g in grads.items())


def test_plan_depth_is_validated(deep):
    cfg, model, batch = deep
    with pytest.raises(ValueError, match="solved for 3 layers"):
        _loss_and_grads(cfg, model, batch,
                        CheckpointConfig(plan=RematPlan(3, (1,))))


# --------------------------------------------------------------------------
# Selective remat policies and the chunked CE, against the JAX package.
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def deep_jax():
    """The 4-layer smoke model from one set of JAX weights: (JAX config on
    its flash path, params, port config, port model) and one batch."""
    jcfg = dataclasses.replace(jconfigs.smoke_config("llama3-8b"),
                               n_layers=4, attn_backend="interpret")
    params = jtf.init_params(jcfg, jax.random.PRNGKey(3))
    cfg = dataclasses.replace(configs.smoke_config("llama3-8b"), n_layers=4)
    model = bridge.load_jax_params(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu").requires_grad_()
    (t, lab), = _batches(cfg.vocab, 1, seed=4)
    return jcfg, params, cfg, model, (t, lab)


POLICY_REMATS = {
    "dots": (CheckpointConfig(policy="dots"), JCheckpointConfig(policy="dots")),
    "dots_nobatch": (CheckpointConfig(policy="dots_nobatch"),
                     JCheckpointConfig(policy="dots_nobatch")),
    "save_names": (CheckpointConfig(save_names=("attn_out", "ffn_out")),
                   JCheckpointConfig(save_names=("attn_out", "ffn_out"))),
    "dots_and_names": (
        CheckpointConfig(policy="dots", save_names=("attn_out",)),
        JCheckpointConfig(policy="dots", save_names=("attn_out",))),
    "plan_full_dots": (
        CheckpointConfig(plan=RematPlan(4, (1, 3), ("full", "dots",
                                                    "dots"))),
        JCheckpointConfig(plan=JRematPlan(4, (1, 3), ("full", "dots",
                                                      "dots")))),
}


def _grad_tree(grads):
    return dict(jax.tree_util.tree_leaves_with_path(bridge.to_jax_tree(grads)))


def _jax_loss_and_grads(jcfg, params, batch, remat, **kw):
    def f(p):
        return jtf.loss_fn(p, jcfg, batch, remat=remat, **kw)[0]
    loss, g = jax.value_and_grad(f)(params)
    return float(loss), dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, g)))


@pytest.mark.parametrize("name", sorted(POLICY_REMATS))
def test_selective_policies_match_jax_and_remat_off(deep_jax, monkeypatch,
                                                    name):
    jcfg, params, cfg, model, (t, lab) = deep_jax
    remat, jremat = POLICY_REMATS[name]
    batch = _torch_batch(t, lab)
    loss0, grads0, _ = _loss_and_grads(cfg, model, batch, REMATS["off"])
    calls = []
    real = flash_ref.flash_fwd_ref
    monkeypatch.setattr(flash_ref, "flash_fwd_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loss, grads, finite = _loss_and_grads(cfg, model, batch, remat)
    assert bool(finite)
    # against the port with remat off: the same arithmetic, rerun
    assert abs(float(loss) - float(loss0)) <= 1e-6 * abs(float(loss0))
    for n, g in grads.items():
        ref = float(grads0[n].abs().max())
        assert float((g - grads0[n]).abs().max()) <= 1e-6 * ref, n
    # the flash forward is no product: every recomputed layer runs it again
    assert len(calls) == 2 * cfg.n_layers
    # against the JAX package under the same policy (f32)
    jloss, jgrads = _jax_loss_and_grads(jcfg, params, _jax_batch(t, lab),
                                        jremat)
    assert abs(float(loss) - jloss) <= 1e-4
    got = _grad_tree(grads)
    assert got.keys() == jgrads.keys()
    for path, g in got.items():
        assert np.abs(g - jgrads[path]).max() <= 1e-4, path


class _OpCount(TorchDispatchMode):
    """Counts the operators dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = str(func.overloadpacket)
        self.n[key] = self.n.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(cfg, model, batch, remat):
    loss, _ = tf.loss_fn(model, cfg, batch, remat=remat)
    with _OpCount() as count:
        loss.backward()
    model.zero_grad(set_to_none=True)
    return count.n


def test_policies_recompute_what_they_say(deep):
    """In the backward: ``full`` re-runs the blocks' products, ``dots``
    and ``dots_nobatch`` re-run none (each block's products are 2-D
    ``aten.mm``), and all three re-run the flash forward, one operator to
    the dispatcher, once per layer."""
    cfg, model, batch = deep
    off = _backward_ops(cfg, model, batch, REMATS["off"])
    assert off.get("repro_torch.flash_fwd", 0) == 0
    for policy, extra_mm in (("full", True), ("dots", False),
                             ("dots_nobatch", False)):
        n = _backward_ops(cfg, model, batch,
                          CheckpointConfig(policy=policy))
        assert n["repro_torch.flash_fwd"] == cfg.n_layers, policy
        assert (n["aten.mm"] > off["aten.mm"]) == extra_mm, (policy, n)
        if not extra_mm:
            assert n["aten.mm"] == off["aten.mm"], policy
    # save_names keeps the tagged tensors: the tag is never re-run
    n = _backward_ops(cfg, model, batch,
                      CheckpointConfig(save_names=("attn_out", "ffn_out")))
    assert n.get("repro_torch.checkpoint_name", 0) == 0
    assert n["repro_torch.flash_fwd"] == cfg.n_layers


def test_tags_only_when_asked(deep, monkeypatch):
    """The tag is a copy, so the forward applies it only under a
    save_names policy that recomputes some segment, and only the names
    asked for."""
    cfg, model, batch = deep
    from repro_torch.core import checkpoint as ckpt_mod
    names = []
    real = ckpt_mod.checkpoint_name
    monkeypatch.setattr(tf, "checkpoint_name",
                        lambda x, n: names.append(n) or real(x, n))
    L = cfg.n_layers
    for remat in (CheckpointConfig(), CheckpointConfig(policy="dots"),
                  CheckpointConfig(enabled=False,
                                   save_names=("attn_out",)),
                  CheckpointConfig(policy="none", save_names=("attn_out",)),
                  CheckpointConfig(save_names=("attn_out",), plan=RematPlan(
                      L, (1,), ("none", "none")))):
        tf.loss_fn(model, cfg, batch, remat=remat)
    assert names == []
    tf.loss_fn(model, cfg, batch,
               remat=CheckpointConfig(save_names=("ffn_out",)))
    assert names == ["ffn_out"] * L
    names.clear()           # one recomputed segment: the model tags
    tf.loss_fn(model, cfg, batch, remat=CheckpointConfig(
        save_names=("ffn_out",), plan=RematPlan(L, (1,), ("none", "dots"))))
    assert names == ["ffn_out"] * L


def test_unknown_policy_raises(deep):
    cfg, model, batch = deep
    with pytest.raises(ValueError, match="unknown remat policy"):
        _loss_and_grads(cfg, model, batch, CheckpointConfig(policy="dot"))


@pytest.mark.parametrize("chunk", [8, 12, 32, 100])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_ce_matches_jax_and_unchunked(smoke, chunk, masked):
    """chunk 8 divides S=32; 12 leaves a ragged last chunk of 8; 32 and
    100 are one chunk.  Tolerance 1e-5: f32 sums in another order."""
    jcfg, cfg, params, tree = smoke
    jcfg = dataclasses.replace(jcfg, attn_backend="interpret")
    model = bridge.load_jax_params(cfg, tree, device="cpu").requires_grad_()
    (t, lab), = _batches(cfg.vocab, 1, seed=5)
    jb, tb = _jax_batch(t, lab), _torch_batch(t, lab)
    if masked:
        mask = (np.random.default_rng(6).random(t.shape) < 0.7).astype(
            np.float32)
        jb["loss_mask"] = jnp.asarray(mask)
        tb["loss_mask"] = torch.from_numpy(mask)
    vg = scaled_value_and_grad(
        lambda m, b, c: tf.loss_fn(m, cfg, b, remat=REMATS["off"],
                                   ce_chunk=c))
    (loss, _), grads, _ = vg(model, tb, chunk)
    (loss0, _), grads0, _ = vg(model, tb, 0)
    jloss, jgrads = _jax_loss_and_grads(jcfg, params, jb,
                                        JCheckpointConfig(enabled=False),
                                        ce_chunk=chunk)
    assert abs(float(loss) - jloss) <= 1e-5
    assert abs(float(loss) - float(loss0)) <= 1e-5
    got = _grad_tree(grads)
    for path, g in got.items():
        assert np.abs(g - jgrads[path]).max() <= 1e-5, path
    for n, g in grads.items():
        assert float((g - grads0[n]).abs().max()) <= 1e-5, n


def test_chunked_ce_never_holds_the_whole_logits(deep, monkeypatch):
    """The LM head runs once per chunk, on (B, chunk, D) rows."""
    cfg, model, batch = deep
    rows = []
    real = tf._mask_padded_vocab
    monkeypatch.setattr(tf, "_mask_padded_vocab",
                        lambda x, c, **kw: rows.append(x.shape[1])
                        or real(x, c, **kw))
    tf.loss_fn(model, cfg, batch, ce_chunk=12)
    assert rows == [12, 12, 8]


@pytest.mark.parametrize("budget_mb", [30, 60, 80, 1000])
def test_resolve_remat_plan_equals_jax(budget_mb):
    """The plan the budget solves from the transformer profile, in both
    packages, for llama3-8b's 4-layer smoke config at 64 x 1024 tokens
    (carry 8 MiB a layer, so MiB budgets bind)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config("llama3-8b"),
                               n_layers=4, attn_backend="interpret")
    cfg = dataclasses.replace(configs.smoke_config("llama3-8b"), n_layers=4)
    jtc = jresolve(jcfg, JTrainConfig(mem_budget_mb=budget_mb),
                   {"tokens": jax.ShapeDtypeStruct((64, 1024), jnp.int32)})
    step, tc = make_train_step(
        cfg, TrainConfig(mem_budget_mb=budget_mb),
        {"tokens": torch.empty((64, 1024), dtype=torch.int32,
                               device="meta")})
    assert callable(step)
    assert tc.remat.plan.to_json() == jtc.remat.plan.to_json()
    assert resolve_remat(cfg, TrainConfig(mem_budget_mb=budget_mb), {
        "tokens": torch.empty((64, 1024), device="meta")}).remat.plan == \
        tc.remat.plan


def test_existing_plan_wins_and_is_validated():
    cfg = dataclasses.replace(configs.smoke_config("llama3-8b"), n_layers=4)
    sds = {"tokens": torch.empty((64, 1024), device="meta")}
    mine = RematPlan(4, (2,), "dots", source="mine")
    tc = TrainConfig(mem_budget_mb=30, remat=CheckpointConfig(plan=mine))
    assert resolve_remat(cfg, tc, sds).remat.plan is mine
    with pytest.raises(ValueError, match="solved for 3 layers"):
        resolve_remat(cfg, TrainConfig(remat=CheckpointConfig(
            plan=RematPlan(3, (1,)))), sds)
    # no budget, or remat off: no plan
    assert resolve_remat(cfg, TrainConfig(), sds).remat.plan is None
    assert resolve_remat(cfg, TrainConfig(mem_budget_mb=30, remat=(
        CheckpointConfig(enabled=False))), sds).remat.plan is None


def test_microbatch_specs_divide_by_accum():
    sds = {"tokens": torch.empty((8, 128), device="meta")}
    assert microbatch_specs(sds, accum=4)["tokens"].shape == (2, 128)
    assert microbatch_specs(sds, accum=16)["tokens"].shape == (1, 128)


def test_checkpoint_sequential_and_remat_scan_recompute():
    torch.manual_seed(0)
    ws = [torch.randn(8, 8, requires_grad=True) for _ in range(5)]
    runs = []

    def layer(i):
        def f(x):
            runs.append(i)
            return torch.tanh(x @ ws[i])
        return f

    x = torch.randn(3, 8)
    plain = x
    for i in range(5):
        plain = layer(i)(plain)
    want = torch.autograd.grad(plain.sum(), ws)
    for seq in (checkpoint_sequential([layer(i) for i in range(5)], 3),
                lambda x: remat_scan(lambda c, i: layer(i)(c), x, range(5))):
        runs.clear()
        got = torch.autograd.grad(seq(x).sum(), ws)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        # checkpoint_sequential: every segment but the last reruns
        # (segments [0,2) [2,3) [3,5)); remat_scan: every block reruns
        assert sorted(runs) == ([0, 0, 1, 1, 2, 2, 3, 4]
                                if len(runs) == 8 else
                                [0, 0, 1, 1, 2, 2, 3, 3, 4, 4])


def test_one_line_wrappers():
    torch.manual_seed(1)
    w = {"a": torch.randn(4, 4, requires_grad=True)}
    x = torch.randn(2, 4)

    def apply_fn(p, x):
        return torch.relu(x @ p["a"]) @ p["a"]

    want = torch.autograd.grad(apply_fn(w, x).sum(), [w["a"]])[0]
    got = torch.autograd.grad(api.sc(apply_fn)(w, x).sum(), [w["a"]])[0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    out = api.sc_mp(apply_fn, mp_policy="bf16")(w, x)
    assert out.dtype == torch.float32          # the policy's output dtype
    g = torch.autograd.grad(out.sum(), [w["a"]])[0]
    assert g.dtype == torch.float32            # master weights stay f32
    torch.testing.assert_close(g, want, rtol=5e-2, atol=5e-2)


# --------------------------------------------------------------------------
# Layers, mixed precision, AdamW.
# --------------------------------------------------------------------------
def test_rms_norm_bf16_grad_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal((2, 5, 64)).astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    _, vjp = jax.vjp(lambda x, w: jlayers.rms_norm(x, w, 1e-5,
                                                   bf16_grad=True), xb, wb)
    dx_j, dw_j = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).bfloat16().requires_grad_()
    out = layers.rms_norm(xt, wt, 1e-5, bf16_grad=True)
    torch.testing.assert_close(
        out.float(), torch.from_numpy(np.array(
            jlayers.rms_norm(xb, wb, 1e-5).astype(jnp.float32))),
        rtol=0, atol=0)                       # forward values identical
    out.backward(torch.from_numpy(g).bfloat16())
    assert xt.grad.dtype == torch.bfloat16    # the cotangent stays bf16
    # both compute in f32 and round once to bf16: at most one bf16 ulp
    for got, want in ((xt.grad, dx_j), (wt.grad, dw_j)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=2 ** -7, atol=1e-6)


def test_adamw_decay_follows_the_jax_layout_rank(smoke):
    jcfg, cfg, params, tree = smoke
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape)
                         .astype(np.float32), tree)
    ocfg = dict(lr=0.1, weight_decay=0.5, warmup_steps=1)
    want, _, jm = jadamw.update(jadamw.AdamWConfig(**ocfg),
                                jax.tree.map(jnp.asarray, grads),
                                jadamw.init(params), params)
    model, opt = _port_state(cfg, tree)
    ps = dict(model.named_parameters())
    decay = adamw.jax_layout_decay_mask(ps)
    assert decay["blocks.0.ln1"] and decay["blocks.1.ln2"]
    assert not decay["final_norm"] and decay["embed"]
    gt = {n: torch.from_numpy(a.copy())
          for n, a in bridge.from_jax_tree(grads).items()}
    _, opt, m = adamw.update(adamw.AdamWConfig(**ocfg), gt, opt, ps,
                             decay=decay)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-6)
    got = bridge.export_params(model)
    for (path, w), (_, g) in zip(
            jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                             want)),
            jax.tree_util.tree_leaves_with_path(got)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=str(path))
    # without the mask the per-layer norms would escape the decay
    model2, opt2 = _port_state(cfg, tree)
    adamw.update(adamw.AdamWConfig(**ocfg), gt, opt2,
                 dict(model2.named_parameters()))
    assert not torch.equal(model2.blocks[0].ln1, model.blocks[0].ln1)


def test_adamw_skip_freezes_everything():
    p = {"w": torch.randn(3, 3), "b": torch.randn(3)}
    before = {n: t.clone() for n, t in p.items()}
    opt = adamw.init(p)
    g = {n: torch.randn_like(t) for n, t in p.items()}
    _, opt, _ = adamw.update(adamw.AdamWConfig(), g, opt, p,
                             skip=torch.tensor(True))
    assert int(opt.count) == 0
    assert all(torch.equal(p[n], before[n]) for n in p)
    assert all(not m.any() for m in list(opt.mu.values())
               + list(opt.nu.values()))
    _, opt, _ = adamw.update(adamw.AdamWConfig(), g, opt, p,
                             skip=torch.tensor(False))
    assert int(opt.count) == 1 and not torch.equal(p["w"], before["w"])


def test_loss_scale_growth_and_backoff_match_jax():
    flags = [True, True, True, False, True, True, False, False]
    ls = LossScale.init(2.0 ** 4, growth_interval=2)
    jls = JLossScale.init(2.0 ** 4, growth_interval=2)
    for f in flags:
        ls = ls.update(torch.tensor(f))
        jls = jls.update(jnp.bool_(f))
        assert float(ls.scale) == float(jls.scale)
        assert int(ls.growth_counter) == int(jls.growth_counter)
    assert LossScale.noop().update(torch.tensor(False)).scale == 1.0


def test_scaled_value_and_grad_unscales_and_flags(deep):
    cfg, model, batch = deep

    def lf(m, b):
        return tf.loss_fn(m, cfg, b, remat=CheckpointConfig(enabled=False))

    (loss0, _), g0, fin0 = scaled_value_and_grad(lf)(model, batch)
    ls = LossScale.init(2.0 ** 10)
    (loss, _), g, fin = scaled_value_and_grad(lf, ls)(model, batch)
    assert bool(fin0) and bool(fin)
    assert float(loss) == pytest.approx(float(loss0), rel=1e-6)
    for n in g0:
        torch.testing.assert_close(g[n], g0[n], rtol=1e-5, atol=1e-7)
        assert g[n].dtype == torch.float32
    bad = {"x": torch.tensor([1.0, float("inf")])}
    assert not bool(all_finite(bad.values()))


# --------------------------------------------------------------------------
# The CLI.
# --------------------------------------------------------------------------
def _cli(*args, tmp):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp / "ck"),
         "--log-every", "1", "--ckpt-every", "2", *args],
        env=env, capture_output=True, text=True, timeout=240)


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    first = _cli("--device", "cpu", "--steps", "3", "--fresh", "--guard",
                 "--events", str(tmp_path / "ev.jsonl"), tmp=tmp_path)
    assert first.returncode == 0, first.stderr[-2000:]
    assert "step     2 loss" in first.stdout and "done" in first.stdout
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002",
                                                   "step_00000003"]
    second = _cli("--device", "cpu", "--steps", "5", tmp=tmp_path)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "resumed from step 3 (data batch 3)" in second.stdout
    assert "step     4 loss" in second.stdout


def test_cli_needs_the_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    out = _cli("--steps", "1", "--fresh", tmp=tmp_path)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
