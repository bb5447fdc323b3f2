"""The port's mesh, sharding rules and per-device budgets against the JAX
package's on abstract meshes (no devices, no process group).

Every rule and budget is a pure function of (config, shapes, mesh), so
each is held EXACTLY: spec entries (``None``, an axis name or a tuple of
names) against ``PartitionSpec`` entries, bytes to the byte.  Every arch
at full width, on ``tests/test_mesh_parallel.py``'s ``MESH_SHAPES`` and
one ("pod", "data", "model") mesh.

The port's parameters are per layer (``blocks.<i>.<path>``) where the
reference stacks each block leaf along a leading layer axis, so a block
leaf's port spec is the reference's without that (replicated) entry.

One budget differs by design, not by rule: hymba's global layers are
flash-eligible in the port's planner and not in the reference's
(``tests/test_torch_plan.py::test_hymba_eligibility_differs_from_jax_on_purpose``),
so its attention residuals differ at every mesh; for hymba the test
holds the per-device DIVISOR instead (the port's residuals at
``model_shards`` equal its whole residuals over the shard factor the
reference's gate applies).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro import plan as jplan
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.models import transformer as jtf
from repro.train import train_step as jts
from repro_torch import configs, plan
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tf
from repro_torch.train import train_step as ts

MESH_SHAPES = [(1, 1), (2, 1), (1, 2), (2, 4), (1, 8)]
MESHES = [(s, ("data", "model")) for s in MESH_SHAPES] + \
    [((2, 2, 2), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]
ARCHS = jconfigs.list_archs()
STACKED = ("blocks", "enc_blocks")


def _meshes(shape, axes):
    """(the reference's abstract mesh, the port's Mesh) of one shape."""
    return jmesh.abstract_mesh(shape, axes), \
        tmesh.Mesh(**dict(zip(axes, shape)))


def _entries(spec) -> tuple:
    return tuple(spec)


def _flat_specs(tree) -> dict:
    """{dotted path: spec entries} of a reference spec tree."""
    return {".".join(str(k.key) for k in path): _entries(s)
            for path, s in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))}


def _flat_shapes(tree) -> dict:
    return {".".join(str(k.key) for k in path): x
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _param_shapes(arch: str):
    """(the reference's param shape tree, the port's {name: shape})."""
    jsds = jax.eval_shape(lambda: jtf.init_params(
        jconfigs.get_config(arch), jax.random.PRNGKey(0)))
    model = tf.init_params(configs.get_config(arch), 0, device="meta")
    return jsds, {n: tuple(p.shape) for n, p in model.named_parameters()}


def _jcfg(arch: str, **kw):
    return dataclasses.replace(jconfigs.get_config(arch), **kw)


# --------------------------------------------------------------------------
# The mesh.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("max_model", [1, 2, 4, 16])
def test_make_mesh_for_equals_jax(monkeypatch, max_model):
    """The grid the reference picks for n = 1..16, captured from its
    ``make_mesh`` call (the reference's module is monkeypatched for the
    test only; nothing is edited)."""
    monkeypatch.setattr(jmesh, "make_mesh",
                        lambda shape, axes, **kw: (tuple(shape), tuple(axes)))
    for n in range(1, 17):
        want = jmesh.make_mesh_for(n, max_model=max_model)
        got = tmesh.make_mesh_for(n, max_model=max_model)
        assert (got.sizes, got.axis_names) == want, n
        assert got.size == n
    for multi_pod in (False, True):
        want = jmesh.make_production_mesh(multi_pod=multi_pod)
        got = tmesh.make_production_mesh(multi_pod=multi_pod)
        assert (got.sizes, got.axis_names) == want


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_describe_and_mesh_value(shape, axes):
    jm, m = _meshes(shape, axes)
    assert tmesh.describe(m) == jmesh.describe(jm)
    assert m.size == jm.size and dict(m.shape) == dict(jm.shape)
    assert m.axis_names == tuple(jm.axis_names)
    assert m == tmesh.Mesh(**dict(zip(axes, shape))) and hash(m) == hash(
        tmesh.Mesh(**dict(zip(axes, shape))))
    with pytest.raises(AttributeError):
        m.x = 1


def test_mesh_rejects_bad_axes_and_needs_a_group():
    with pytest.raises(ValueError):
        tmesh.Mesh()
    with pytest.raises(ValueError):
        tmesh.Mesh(data=0)
    assert tmesh.make_mesh_for() == tmesh.Mesh(data=1, model=1)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.device_mesh(tmesh.Mesh(data=1, model=1), "cpu")


# --------------------------------------------------------------------------
# The rules.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, shape, axes):
    jm, m = _meshes(shape, axes)
    jsds, shapes = _param_shapes(arch)
    for mesh, jmesh_ in ((m, jm), (None, None)):   # fitted, then raw
        want = _flat_specs(jshd.param_specs(jconfigs.get_config(arch), jsds,
                                            mesh=jmesh_))
        got = shd.param_specs(configs.get_config(arch), shapes, mesh=mesh)
        seen = set()
        for name, spec in got.items():
            key = ".".join(p for p in name.split(".") if not p.isdigit())
            ref = want[key]
            if key.split(".")[0] in STACKED and ref:
                assert ref[0] is None, (key, ref)   # layers never shard
                ref = ref[1:]
            assert spec == ref, (name, spec, ref)
            seen.add(key)
        assert seen == set(want)


@pytest.mark.parametrize("mode", ["replicated", "tp", "ep"])
def test_param_specs_ep_and_ssm(mode):
    """Expert parallelism (the EP rule tests a per-layer (E, D, F) leaf)
    and the SSM family (every leaf replicated) on a 2 x 4 mesh."""
    jm, m = _meshes((2, 4), ("data", "model"))
    if mode == "ep":
        jcfg = _jcfg("deepseek-moe-16b")
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, expert_mode="ep"))
        cfg = configs.get_config("deepseek-moe-16b")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, expert_mode="ep"))
        arch = "deepseek-moe-16b"
    else:
        arch = "mamba2-130m" if mode == "replicated" else "granite-moe-3b-a800m"
        jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jsds, shapes = _param_shapes(arch)
    want = _flat_specs(jshd.param_specs(jcfg, jsds, mesh=jm))
    got = shd.param_specs(cfg, shapes, mesh=m)
    for name, spec in got.items():
        key = ".".join(p for p in name.split(".") if not p.isdigit())
        ref = want[key][1:] if key.startswith("blocks.") and want[key] \
            else want[key]
        assert spec == ref, (name, spec, ref)
    if mode == "ep":
        assert got["blocks.0.ffn.w_gate"] == ("model", None, None)
    if mode == "replicated":
        assert all(s == () for n, s in got.items() if ".ssm." in n)


def _caches(arch: str, b: int, s: int, quantized: bool, two_tier: bool):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    if two_tier:
        jc = jax.eval_shape(lambda: jtf.init_cache_two_tier(
            jcfg, b, s, quantized=quantized))
        tc = tf.init_cache_two_tier(cfg, b, s, quantized=quantized,
                                    device="meta")
    else:
        jc = jax.eval_shape(lambda: jtf.init_cache(jcfg, b, s,
                                                   quantized=quantized))
        tc = tf.init_cache(cfg, b, s, quantized=quantized, device="meta")
    return jcfg, cfg, jc, tc


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch, shape, axes):
    """Decode-cache and slot-pool specs, int8 and bf16, two batch / length
    shapes (one that divides every axis, one that divides none), and the
    two-tier cache where the arch has one."""
    jm, m = _meshes(shape, axes)
    cfg0 = configs.get_config(arch)
    tiers = [False] + ([True] if cfg0.window > 0 and cfg0.global_layers
                       else [])
    for b, s in ((8, 256), (3, 100)):
        for quantized in (True, False):
            for two_tier in tiers:
                jcfg, cfg, jc, tc = _caches(arch, b, s, quantized, two_tier)
                assert set(tc) == set(jc)
                for fn, jfn in ((shd.cache_specs, jshd.cache_specs),
                                (shd.serve_cache_specs,
                                 jshd.serve_cache_specs)):
                    want = _flat_specs(jfn(jcfg, jc, jm))
                    got = fn(cfg, tc, m)
                    assert got == want, (fn.__name__, b, s, quantized,
                                         two_tier)
                    for name, spec in got.items():
                        assert shd.spec_shards(m, spec) == jshd.spec_shards(
                            jm, P(*spec))


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_batch_flash_and_kv_rules_equal_jax(shape, axes):
    """Batch specs (M-RoPE's (3, B, S) positions on dim 1, an encoder's
    frames), the flash shard spec and the serve KV mode over a grid of
    batch / head / length counts."""
    jm, m = _meshes(shape, axes)
    b, s = 8, 64
    shapes = {"tokens": (b, s), "labels": (b, s), "positions": (3, b, s),
              "frames": (b, 32, 80)}
    jbatch = {k: jax.ShapeDtypeStruct(v, jnp.int32)
              for k, v in shapes.items()}
    got = shd.batch_specs(None, shapes, m)
    assert got == _flat_specs(jshd.batch_specs(None, jbatch, jm))
    assert got["positions"][0] is None and got["positions"][1] is not None
    for batch in (1, 2, 3, 8):
        for heads in (1, 4, 6, 8, 32):
            for kv in (1, 2, 4, 8):
                want = jshd.flash_shard_specs(jm, batch, heads, kv)
                spec = shd.flash_shard_specs(m, batch, heads, kv)
                assert spec == (None if want is None else _entries(want))
    assert shd.flash_shard_specs(None, 8, 8, 8) is None
    for kv in (1, 2, 3, 8):
        for length in (63, 64, 100, 128):
            assert shd.serve_kv_shard(m, kv, length) == \
                jshd.serve_kv_shard(jm, kv, length)
    assert shd.serve_kv_shard(None, 8, 64) == "none"
    assert shd.dp_axes(m) == jshd.dp_axes(jm)
    assert shd.dp_size(m) == jshd.dp_size(jm)


def test_spec_shards_counts_devices():
    _, m = _meshes((2, 4), ("data", "model"))
    assert shd.spec_shards(m, ()) == 1
    assert shd.spec_shards(m, (None, "model")) == 4
    assert shd.spec_shards(m, ("data", "model")) == 8
    assert shd.spec_shards(m, (("data", "model"),)) == 8


class _Dims:
    """The part of a ``DeviceMesh`` :func:`shd.to_placements` reads."""
    def __init__(self, *names):
        self.mesh_dim_names = names


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    dm = _Dims("data", "model")
    assert shd.to_placements(dm, ()) == (Replicate(), Replicate())
    assert shd.to_placements(dm, ("data", None)) == (Shard(0), Replicate())
    assert shd.to_placements(dm, (None, "data", "model")) == (Shard(1),
                                                              Shard(2))
    pod = _Dims("pod", "data", "model")
    assert shd.to_placements(pod, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError, match="lacks"):
        shd.to_placements(dm, ("pod",))


# --------------------------------------------------------------------------
# Per-device budgets.
# --------------------------------------------------------------------------
def _resid_equal(arch, cfg, jcfg, b, s, ctx, model_shards, **kw):
    """The port's attention residuals at ``model_shards`` against the
    reference's (see the module docstring for hymba)."""
    got = plan.attn_resid_bytes(cfg, b, s, ctx=ctx,
                                model_shards=model_shards, **kw)
    if plan.flash_training_eligible(cfg, s) == \
            jplan.flash_training_eligible(jcfg, s):
        assert got == jplan.attn_resid_bytes(jcfg, b, s, ctx,
                                             model_shards=model_shards, **kw)
    else:
        whole = jplan.attn_resid_bytes(jcfg, b, s, ctx, **kw)
        factor = whole // jplan.attn_resid_bytes(
            jcfg, b, s, ctx, model_shards=model_shards, **kw)
        assert got == plan.attn_resid_bytes(cfg, b, s, ctx=ctx, **kw) \
            // factor
    return got


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_budgets_equal_jax(arch, shape, axes):
    """``attn_resid_bytes(model_shards=)`` and
    ``serve_capacity_report(mesh=)`` at full width (the JAX side on its
    flash path, ``attn_backend="interpret"``), two ``s_max`` and budgets."""
    jm, m = _meshes(shape, axes)
    cfg = configs.get_config(arch)
    jcfg = _jcfg(arch, attn_backend="interpret")
    n_model = m.shape["model"]
    for b, s, ctx in ((2, 256, 256), (1, 1024, 512)):
        for kw in ({}, {"dtype_bytes": 4, "flash_resid_bytes": 2}):
            _resid_equal(arch, cfg, jcfg, b, s, ctx, n_model, **kw)
    for s_max, budget in ((2048, 8 * 2 ** 30), (4000, 10 ** 9)):
        for quantized in (True, False):
            kw = dict(quantized=quantized, params_bytes=12345, mesh=m)
            got = plan.serve_capacity_report(cfg, s_max, budget, **kw)
            assert got == jplan.serve_capacity_report(
                jcfg, s_max, budget, **{**kw, "mesh": jm})
            assert got["bytes_per_slot_per_device"] * got["model_shards"] \
                >= got["bytes_per_slot"]


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_profile_per_device_equals_jax(arch, shape, axes):
    """``plan_profile(mesh=)`` (the per-device microbatch, the residuals
    over the model shards) and ``microbatch_specs(mesh=)`` on the smoke
    configs: carry and residual bytes and labels, accum 1 and 2."""
    jm, m = _meshes(shape, axes)
    cfg = configs.smoke_config(arch)
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch),
                               attn_backend="interpret")
    b, s = 8, 128
    jsds = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    sds = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
    for accum in (1, 2):
        for policy in ("full", "bf16"):
            tc = ts.TrainConfig(policy=policy, accum=accum)
            jtc = jts.TrainConfig(policy=policy, accum=accum)
            mb = ts.microbatch_specs(sds, accum=accum, mesh=m)["tokens"]
            jmb = jts.microbatch_specs(jsds, accum=accum, mesh=jm)["tokens"]
            assert tuple(mb.shape) == tuple(jmb.shape)
            got = ts.plan_profile(cfg, tc, sds, mesh=m)
            want = jts.plan_profile(jcfg, jtc, jsds, mesh=jm)
            assert got.act_bytes == want.act_bytes
            assert got.labels == want.labels
            if plan.flash_training_eligible(cfg, s) == \
                    jplan.flash_training_eligible(jcfg, s):
                assert got.resid_bytes == want.resid_bytes
            else:
                whole = ts.plan_profile(cfg, tc, sds, mesh=tmesh.Mesh(
                    data=shd.dp_size(m), model=1))
                jwhole = jts.plan_profile(jcfg, jtc, jsds, mesh=jmesh.
                                          abstract_mesh(
                                              (jshd.dp_size(jm), 1),
                                              ("data", "model")))
                for r, rw, jr, jrw in zip(got.resid_bytes, whole.resid_bytes,
                                          want.resid_bytes,
                                          jwhole.resid_bytes):
                    assert r == (rw // (jrw // jr) if jr else 0)


def test_trainer_refuses_a_model_axis():
    cfg = configs.smoke_config("llama3-8b")
    # tensor parallelism trains, over a process group of the mesh's size
    with pytest.raises(RuntimeError, match="process group"):
        ts.build_train_step(cfg, ts.TrainConfig(),
                            mesh=tmesh.Mesh(data=1, model=2))
    # MLA does not shard over the model axis (the MoE does)
    with pytest.raises(NotImplementedError, match="MLA"):
        ts.build_train_step(configs.smoke_config("minicpm3-4b"),
                            ts.TrainConfig(),
                            mesh=tmesh.Mesh(data=1, model=2))
    with pytest.raises(RuntimeError, match="process group"):
        ts.build_train_step(cfg, ts.TrainConfig(),
                            mesh=tmesh.Mesh(data=2, model=1))
    # DP 1 without a group: the meshless step
    ts.build_train_step(cfg, ts.TrainConfig(),
                        mesh=tmesh.Mesh(data=1, model=1))
