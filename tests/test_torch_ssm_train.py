"""Training the SSM family (mamba2-130m, hymba-1.5b smoke configs) in the
port against the JAX package, on the CPU, from the same weights
(``bridge.load_jax_params``) and the same numpy batches: the loss and every
gradient of ``loss_fn`` (leaf by leaf in the JAX layout,
``bridge.to_jax_tree``) under remat on and off, three AdamW steps of
``build_train_step`` against the JAX ``train_step``, the optimizer state
both ways through the bridge, and ``launch/train.py`` for mamba2: a run
with checkpoints, its resume, ``--no-remat``, and ``--remat auto
--mem-budget-mb 1`` against the JAX trainer's plan.  The SSD chunk's
gradient runs through the port's ``_SSDChunkFn`` (the plain backward on
the CPU, ``ssd_bwd.cu`` on the card).

Tolerances, each with its reason:
  * policy ``full``: loss and every gradient within 1e-4 of the largest
    entry of the JAX gradient (f32 on both sides, sums in another order;
    the chunked scan's recurrence and y_inter are rounded differently);
  * three AdamW steps: losses within 1e-3 relative (ROADMAP's tolerance for
    training losses), and 1e-4 absolute under ``full``;
  * ``bf16``: losses within 1e-3 relative: XLA rounds once per fusion,
    PyTorch after every op (``test_torch_train.py``'s bf16 tolerance).
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.checkpoint import CheckpointConfig as JCheckpointConfig
from repro.core.mixed_precision import LossScale as JLossScale
from repro.core.mixed_precision import Policy as JPolicy
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import build_train_step as jbuild
from repro_torch import configs
from repro_torch.core.checkpoint import CheckpointConfig
from repro_torch.core.mixed_precision import Policy, scaled_value_and_grad
from repro_torch.models import bridge
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.train.train_step import (TrainConfig, build_train_step,
                                          init_loss_scale)

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAD_TOL, LOSS_RTOL, STEPS = 1e-4, 1e-3, 3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
ARCHS = ["mamba2-130m", "hymba-1.5b"]


def _batch(vocab, b=2, s=64, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)) \
        .astype(np.int32)
    return toks[:, :-1].copy(), toks[:, 1:].copy()


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = jconfigs.smoke_config(request.param)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(2))
    return jcfg, configs.smoke_config(request.param), params, \
        jax.tree.map(np.asarray, params)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_match_jax(arch, remat):
    jcfg, cfg, params, tree = arch
    toks, labels = _batch(cfg.vocab)
    jl, jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)},
                              policy=JPolicy.full(),
                              remat=JCheckpointConfig(enabled=remat))[0])(
        params)
    model = bridge.load_jax_params(cfg, tree, device="cpu").requires_grad_()
    vg = scaled_value_and_grad(lambda m, b: tf.loss_fn(
        m, cfg, b, policy=Policy.full(),
        remat=CheckpointConfig(enabled=remat)))
    (loss, _), grads, finite = vg(model, {"tokens": torch.from_numpy(toks),
                                          "labels": torch.from_numpy(labels)})
    assert bool(finite)
    assert abs(float(loss) - float(jl)) <= GRAD_TOL * abs(float(jl))
    got, want = _flat(bridge.to_jax_tree(grads)), _flat(jg)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        scale = max(1e-12, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= GRAD_TOL * scale, name
    if cfg.mixer == "ssm":              # no MLP: ln2 never reaches the loss
        assert not got["['blocks']['ln2']"].any()
        assert not want["['blocks']['ln2']"].any()


@pytest.mark.parametrize("policy", ["full", "bf16"])
def test_train_steps_match_jax(arch, policy):
    jcfg, cfg, params, tree = arch
    jstep = jax.jit(jbuild(jcfg, JTrainConfig(
        policy=policy, opt=jadamw.AdamWConfig(**OPT))))
    tc = TrainConfig(policy=policy, opt=adamw.AdamWConfig(**OPT))
    step = build_train_step(cfg, tc)
    model = bridge.load_jax_params(cfg, tree, device="cpu").requires_grad_()
    opt = adamw.init(dict(model.named_parameters()))
    ls = init_loss_scale(tc, "cpu")
    jopt, jls = jadamw.init(params), JLossScale.noop()
    for i in range(STEPS):
        toks, labels = _batch(cfg.vocab, seed=i)
        params, jopt, jls, jm = jstep(params, jopt, jls, {
            "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        model, opt, ls, m = step(model, opt, ls, {
            "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)})
        assert bool(m["grads_finite"])
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=LOSS_RTOL)
        if policy == "full":
            assert abs(float(m["loss"]) - float(jm["loss"])) <= GRAD_TOL
    # the moments and the step count carry over to the JAX layout and back
    jopt_np = jax.tree.map(np.asarray, jopt)
    exported = bridge.export_opt_state(opt)
    assert int(exported.count) == int(jopt_np.count) == STEPS
    got_mu, want_mu = _flat(exported.mu), _flat(jopt_np.mu)
    assert sorted(got_mu) == sorted(want_mu)
    back = bridge.load_opt_state(jopt_np, device="cpu")
    assert sorted(back.mu) == sorted(opt.mu)
    for n, t in back.nu.items():
        assert t.shape == opt.nu[n].shape and t.dtype == opt.nu[n].dtype
    if cfg.mixer == "ssm":
        # ln2 gets zero gradients, so no moment; stacked (L, D) in the JAX
        # layout it takes weight decay (``adamw.jax_layout_decay_mask``),
        # so it moves by the decay alone, as JAX's does
        assert not got_mu["['blocks']['ln2']"].any()
        ln2 = torch.stack([b.ln2 for b in model.blocks]).detach().numpy()
        want_ln2 = np.asarray(params["blocks"]["ln2"])
        assert (want_ln2 < 1).all()
        np.testing.assert_allclose(ln2, want_ln2, rtol=1e-6)


def _cli(tmp, *args, module="repro_torch.launch.train", ck="ck"):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", module, "--arch", "mamba2-130m", "--smoke",
         "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp / ck),
         "--log-every", "1", "--ckpt-every", "2", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)


def test_cli_trains_mamba2_and_resumes(tmp_path):
    first = _cli(tmp_path, "--device", "cpu", "--steps", "3", "--fresh",
                 "--guard")
    assert first.returncode == 0, first.stderr[-3000:]
    assert "step     2 loss" in first.stdout and "done" in first.stdout
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002",
                                                   "step_00000003"]
    second = _cli(tmp_path, "--device", "cpu", "--steps", "5")
    assert second.returncode == 0, second.stderr[-3000:]
    assert "resumed from step 3 (data batch 3)" in second.stdout
    assert "step     4 loss" in second.stdout


def test_cli_no_remat_is_remat_off(tmp_path):
    out = _cli(tmp_path, "--device", "cpu", "--steps", "1", "--fresh",
               "--no-remat", "--policy", "full")
    off = _cli(tmp_path, "--device", "cpu", "--steps", "1", "--fresh",
               "--remat", "off", "--policy", "full", ck="ck_off")
    assert out.returncode == 0 and off.returncode == 0, out.stderr[-3000:]
    assert "remat off (full)" in out.stdout

    def loss_line(o):
        return next(ln.split("(")[0] for ln in o.stdout.splitlines()
                    if ln.startswith("step     0 loss"))

    assert loss_line(out) == loss_line(off)


def test_cli_mem_budget_plan_equals_the_jax_trainers(tmp_path):
    args = ("--steps", "1", "--fresh", "--remat", "auto", "--mem-budget-mb",
            "1")
    port = _cli(tmp_path, "--device", "cpu", *args)
    ref = _cli(tmp_path, *args, module="repro.launch.train", ck="jck")
    assert port.returncode == 0, port.stderr[-3000:]
    assert ref.returncode == 0, ref.stderr[-3000:]
    got = json.loads((tmp_path / "ck" / "remat_plan.json").read_text())
    want = json.loads((tmp_path / "jck" / "remat_plan.json").read_text())
    assert got == want
    banner = [ln for ln in port.stdout.splitlines()
              if ln.startswith("remat plan")]
    assert banner and banner == [ln for ln in ref.stdout.splitlines()
                                 if ln.startswith("remat plan")]
