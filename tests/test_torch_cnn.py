"""The port's ResNet (``models/cnn.py``) against the JAX package's on the
CPU, from the same bridged parameters and numpy images: logits, loss,
accuracy and every gradient, for narrow basic and bottleneck variants
with and without ``stem_stride=2`` (the stride-2 convolutions are where
XLA's "SAME" padding, (0, 1) on an even input, differs from
``padding=1``); the packed-input path against the f32 path; sequential
checkpointing against no remat; the parameter and AdamW-state bridge; and
two AdamW steps with weight decay against ``repro.optim.adamw.update``.

Tolerance: f32 on both sides, 1e-4 of max|ref| per tensor (two
implementations that sum in different orders); the remat forms and the
packed path against their plain runs: equal to 1e-6 (the same arithmetic).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core.checkpoint import CheckpointConfig as JCheckpointConfig
from repro.models import cnn as jcnn
from repro.optim import adamw as jadamw
from repro.plan.solver import RematPlan as JRematPlan
from repro_torch.core.checkpoint import CheckpointConfig
from repro_torch.models import bridge, cnn
from repro_torch.optim import adamw
from repro_torch.plan import RematPlan

torch.set_num_threads(2)
REL = 1e-4
VARIANTS = {
    "basic": dict(bottleneck=False, stem_stride=1),
    "basic_stem2": dict(bottleneck=False, stem_stride=2),
    "bottleneck": dict(bottleneck=True, stem_stride=1),
    "bottleneck_stem2": dict(bottleneck=True, stem_stride=2),
}


def _cfgs(bottleneck, stem_stride):
    kw = dict(arch_id="narrow", stage_sizes=(1, 1, 1, 1),
              widths=(8, 16, 32, 64), bottleneck=bottleneck,
              num_classes=10, groups=4, stem_stride=stem_stride)
    return jcnn.ResNetConfig(**kw), cnn.ResNetConfig(**kw)


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale + 1e-7, (err, rel * scale)


def _data(n=8, hw=16, seed=0):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, n).astype(np.int32)
    return u8, labels


def _setup(variant, seed=0):
    jcfg, cfg = _cfgs(**VARIANTS[variant])
    jp = jcnn.init_params(jcfg, jax.random.PRNGKey(seed))
    params = bridge.load_cnn_params(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    return jcfg, cfg, jp, params


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_loss_and_grads_match_jax(variant):
    jcfg, cfg, jp, params = _setup(variant)
    u8, labels = _data(hw=18 if "stem2" in variant else 16)
    imgs = u8.astype(np.float32) / 255.0

    @jax.jit
    def jrun(p):
        logits = jcnn.forward(p, jcfg, jnp.asarray(imgs))
        return logits, jax.value_and_grad(
            lambda q: jcnn.loss_fn(q, jcfg, jnp.asarray(imgs),
                                   jnp.asarray(labels)), has_aux=True)(p)

    jlogits, ((jl, jaux), jg) = jrun(jp)
    for p in params.values():
        p.requires_grad_()
    logits = cnn.forward(params, cfg, torch.from_numpy(imgs))
    _close(logits, jlogits)
    loss, aux = cnn.loss_fn(params, cfg, torch.from_numpy(imgs),
                            torch.from_numpy(labels))
    loss.backward()
    _close(loss, jl)
    assert float(aux["acc"]) == float(jaux["acc"])
    want = bridge.cnn_named_arrays(jax.tree.map(np.asarray, jg))
    assert set(want) == set(params)
    for name, p in params.items():
        assert p.grad.shape == want[name].shape, name
        _close(p.grad, want[name])


@pytest.mark.parametrize("size,k,stride,want", [
    (32, 3, 1, (1, 1)), (32, 3, 2, (0, 1)), (33, 3, 2, (1, 1)),
    (16, 1, 2, (0, 0)), (7, 1, 1, (0, 0)), (512, 3, 2, (0, 1))])
def test_same_padding_is_xla_s(size, k, stride, want):
    assert cnn.same_padding(size, k, stride) == want
    x = jnp.zeros((1, size, 1, 1))
    w = jnp.zeros((k, 1, 1, 1))
    out = jax.lax.conv_general_dilated(
        x, w, (stride, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert out.shape[1] == (size + sum(want) - k) // stride + 1


def test_stride2_same_padding_differs_from_symmetric():
    """The trap the port avoids: padding=1 gives the same shape and other
    numbers for a stride-2 3x3 conv on an even input."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 2, 8, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 2, 3, 3)).astype(np.float32))
    got = cnn._conv(x, w, 2)
    sym = torch.nn.functional.conv2d(x, w, stride=2, padding=1)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
        jnp.asarray(w.permute(2, 3, 1, 0).numpy()), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert got.shape == sym.shape
    _close(got.permute(0, 2, 3, 1), want)
    assert float((got - sym).abs().max()) > 1e-2


@pytest.mark.parametrize("variant", ["basic", "bottleneck_stem2"])
def test_packed_input_equals_f32_input(variant):
    _, cfg, _, params = _setup(variant)
    u8, labels = _data(n=8)
    packed = torch.from_numpy(jenc.pack_u8_to_u32(u8))
    imgs = torch.from_numpy(u8.astype(np.float32) * np.float32(1 / 255.0))
    lab = torch.from_numpy(labels)
    want = cnn.forward(params, cfg, imgs)
    got = cnn.forward(params, cfg, packed, decode=True)
    assert torch.equal(got, want)
    l1, _ = cnn.loss_fn(params, cfg, packed, lab, decode=True)
    l2, _ = cnn.loss_fn(params, cfg, imgs, lab)
    assert torch.equal(l1, l2)


def _grads(params, cfg, imgs, labels, **kw):
    ps = {n: p.detach().clone().requires_grad_() for n, p in params.items()}
    loss, _ = cnn.loss_fn(ps, cfg, imgs, labels, **kw)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in ps.items()}


@pytest.mark.parametrize("remat", [
    CheckpointConfig(),                                   # every layer
    CheckpointConfig(segment_size=2),
    CheckpointConfig(plan=RematPlan(6, (2, 5))),
    CheckpointConfig(plan=RematPlan(6, (1, 3), ("full", "none", "full"))),
    CheckpointConfig(enabled=False)], ids=str)
def test_remat_forms_equal_no_remat(remat):
    _, cfg, _, params = _setup("basic")
    u8, labels = _data()
    imgs = torch.from_numpy(u8.astype(np.float32) / 255.0)
    lab = torch.from_numpy(labels)
    l0, g0 = _grads(params, cfg, imgs, lab)
    l1, g1 = _grads(params, cfg, imgs, lab, remat=remat)
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=1e-7)


def test_remat_plan_of_wrong_depth_raises():
    _, cfg, _, params = _setup("basic")
    with pytest.raises(ValueError, match="layer chain"):
        cnn.forward(params, cfg, torch.zeros((2, 8, 8, 3)),
                    remat=CheckpointConfig(plan=RematPlan(9, (3,))))


def test_remat_plan_matches_jax_checkpointed_grads():
    jcfg, cfg, jp, params = _setup("basic_stem2")
    u8, labels = _data(hw=16)
    imgs = u8.astype(np.float32) / 255.0
    jremat = JCheckpointConfig(plan=JRematPlan(6, (2, 4)))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jcnn.loss_fn(p, jcfg, jnp.asarray(imgs),
                               jnp.asarray(labels), remat=jremat),
        has_aux=True))(jp)
    loss, g = _grads(params, cfg, torch.from_numpy(imgs),
                     torch.from_numpy(labels),
                     remat=CheckpointConfig(plan=RematPlan(6, (2, 4))))
    _close(torch.tensor(loss), jl)
    want = bridge.cnn_named_arrays(jax.tree.map(np.asarray, jg))
    for n in g:
        _close(g[n], want[n])


def test_layer_chain_shape_helpers_equal_jax():
    for cfg_fn, jcfg_fn in ((cnn.resnet18, jcnn.resnet18),
                            (cnn.resnet50, jcnn.resnet50)):
        cfg, jcfg = cfg_fn(), jcfg_fn()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cnn.num_layer_fns(cfg) == jcnn.num_layer_fns(jcfg)
        assert cnn.block_strides(cfg) == jcnn.block_strides(jcfg)
    p = cnn.init_params(cnn.resnet18(), 0, device="cpu")
    jp = jax.eval_shape(lambda: jcnn.init_params(jcnn.resnet18(),
                                                 jax.random.PRNGKey(0)))
    want = {n: a.shape for n, a in bridge.cnn_named_arrays(
        jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), jp)).items()}
    assert {n: tuple(t.shape) for n, t in p.items()} == want


def test_init_params_distribution():
    p = cnn.init_params(cnn.resnet18(), 3, device="cpu")
    # JAX: dense_init over HWIO (fan-in kh) / sqrt(kh kw)
    assert abs(float(p["blocks.1.w1"].std()) - 3 ** -0.5 / 3) < 0.01
    assert abs(float(p["blocks.2.proj"].std()) - 1.0) < 0.05
    assert abs(float(p["head.w"].std()) - 512 ** -0.5) < 0.01
    q = cnn.init_params(cnn.resnet18(), 3, device="cpu")
    assert all(torch.equal(p[n], q[n]) for n in p)


def test_bridge_round_trips_params_and_opt_state():
    jcfg, cfg, jp, params = _setup("bottleneck_stem2")
    tree = jax.tree.map(np.asarray, jp)
    back = bridge.export_cnn_params(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    jopt = jadamw.init(jp)
    jopt = jadamw.AdamWState(
        mu=jax.tree.map(lambda x: x + 1.5, jopt.mu),
        nu=jax.tree.map(lambda x: x + 2.5, jopt.nu),
        count=jnp.asarray(7, jnp.int32))
    opt = bridge.load_cnn_opt_state(jax.tree.map(np.asarray, jopt),
                                    device="cpu")
    assert set(opt.mu) == set(params) and int(opt.count) == 7
    out = bridge.export_cnn_opt_state(opt)
    for a, b in zip(jax.tree.leaves(out.mu), jax.tree.leaves(jopt.mu)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(out.count) == 7


def test_adamw_weight_decay_follows_the_cnn_rank():
    """Two steps with weight_decay=0.1 against ``repro.optim.adamw``: the
    JAX CNN's GroupNorm (C,) scales are rank 1 and take no decay, so the
    CNN passes no decay mask.  The transformer's stacked-layout mask
    (``jax_layout_decay_mask``) would decay them, and is shown wrong here.
    Parameters to 1e-5 abs: AdamW divides by sqrt(v), so a gradient that
    differs in its last digits moves a weight by up to a few ulps of lr
    (1e-3); the wrong decay moves the scaled GroupNorm weights by
    lr * 0.1 * 3 = 3e-4 per step."""
    jcfg, cfg, jp, params = _setup("basic")
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.1)
    jocfg, pocfg = jadamw.AdamWConfig(**ocfg), adamw.AdamWConfig(**ocfg)
    # the GroupNorm scales move away from 1 so that decay would show
    params["blocks.0.s1"].mul_(3.0)
    jp["blocks"][0]["s1"] = jp["blocks"][0]["s1"] * 3.0
    jopt = jadamw.init(jp)
    runs = {}
    for mask in ("none", "stacked"):
        ps = {n: p.detach().clone().requires_grad_()
              for n, p in params.items()}
        decay = None if mask == "none" else adamw.jax_layout_decay_mask(ps)
        runs[mask] = (ps, adamw.init(ps), decay)
    for step in range(2):
        u8, labels = _data(seed=step)
        imgs = u8.astype(np.float32) / 255.0
        jg = jax.jit(jax.grad(lambda p: jcnn.loss_fn(
            p, jcfg, jnp.asarray(imgs), jnp.asarray(labels))[0]))(jp)
        jp, jopt, jm = jadamw.update(jocfg, jg, jopt, jp)
        for ps, opt, decay in runs.values():
            loss, _ = cnn.loss_fn(ps, cfg, torch.from_numpy(imgs),
                                  torch.from_numpy(labels))
            grads = dict(zip(ps, torch.autograd.grad(loss,
                                                     list(ps.values()))))
            _, _, m = adamw.update(pocfg, grads, opt, ps, decay=decay)
            _close(m["grad_norm"], jm["grad_norm"])
    want = bridge.cnn_named_arrays(jax.tree.map(np.asarray, jp))
    ps = runs["none"][0]
    for name in ps:
        err = float(np.abs(ps[name].detach().numpy() - want[name]).max())
        assert err <= 1e-5, (name, err)
    wrong = runs["stacked"][0]["blocks.0.s1"].detach().numpy()
    assert float(np.abs(wrong - want["blocks.0.s1"]).max()) > 4e-4
