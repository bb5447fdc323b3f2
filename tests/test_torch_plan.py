"""The port's planner (``plan/solver.py``, ``plan/profile.py``) against the
JAX package's on the CPU: the ResNet chain's activation bytes (walked on
meta tensors here, with ``jax.eval_shape`` there) and the plan the
example's S-C pipeline solves, exactly; and the solvers on seeded random
chains, exactly.  FLOPs are analytic in the port (XLA's cost analysis has
no counterpart): held to be positive and within a band of XLA's count.

The transformer half: carry and residual bytes, labels, the KV-cache and
serve-capacity reports exactly as JAX's; FLOPs exactly as JAX's at its
128 x 128 tiles with S a multiple of 128, and as the port's kernel
counters at its own 64 x 64 tiles; the decode tile report; the placement
DP and ``activation_bytes_of``; and hymba's eligibility, which differs
from JAX's on purpose."""
from __future__ import annotations

import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import plan as jplan
from repro.core import checkpoint as jckpt
from repro.models import cnn as jcnn
from repro.plan import solver as jsolver
from repro_torch import configs, plan
from repro_torch.core import checkpoint as ckpt
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models import cnn
from repro_torch.plan import solver

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def resnet18_profiles():
    jcfg, cfg = jcnn.resnet18(), cnn.resnet18()
    jp = jcnn.init_params(jcfg, jax.random.PRNGKey(0))
    jprof = jplan.profile_resnet(
        jp, jcfg, jax.ShapeDtypeStruct((32, 32, 32, 3), jnp.float32))
    params = cnn.init_params(cfg, 0, device="cpu")
    prof = plan.profile_resnet(params, cfg,
                               torch.empty((32, 32, 32, 3), device="meta"))
    return jprof, prof


def test_resnet18_act_bytes_equal_jax(resnet18_profiles):
    jprof, prof = resnet18_profiles
    assert prof.act_bytes == jprof.act_bytes
    assert prof.labels == jprof.labels
    assert prof.n_layers == cnn.num_layer_fns(cnn.resnet18()) == 10


def test_resnet18_flops_are_analytic(resnet18_profiles):
    jprof, prof = resnet18_profiles
    # stem: 2 * (32*32*32 outputs * 64 channels) * (3*3*3) multiply-adds
    assert prof.flops[0] == 2 * 32 * 32 * 32 * 64 * 27
    for mine, xla in zip(prof.flops, jprof.flops):
        assert mine > 0 and 0.5 * xla <= mine <= 1.5 * xla, (mine, xla)


def test_example_plan_equals_jax(resnet18_profiles):
    jprof, prof = resnet18_profiles
    jp5, p5 = jplan.plan_min_peak(jprof, 5), plan.plan_min_peak(prof, 5)
    assert p5.boundaries == jp5.boundaries and len(p5.boundaries) == 5
    assert p5.source == jp5.source == "min_peak:k=5"
    assert p5.to_json() == jp5.to_json()


@pytest.mark.parametrize("bottleneck,stem_stride,shape,dtype", [
    (True, 2, (4, 32, 32, 3), torch.float32),
    (False, 1, (8, 16, 16, 3), torch.bfloat16)])
def test_narrow_act_bytes_equal_jax(bottleneck, stem_stride, shape, dtype):
    kw = dict(arch_id="narrow", stage_sizes=(1, 2, 1, 1),
              widths=(8, 16, 32, 64), bottleneck=bottleneck, groups=4,
              stem_stride=stem_stride)
    jcfg, cfg = jcnn.ResNetConfig(**kw), cnn.ResNetConfig(**kw)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jax.tree.map(lambda x: x.astype(jdt),
                      jcnn.init_params(jcfg, jax.random.PRNGKey(1)))
    jprof = jplan.profile_resnet(jp, jcfg, jax.ShapeDtypeStruct(shape, jdt))
    params = cnn.init_params(cfg, 1, device="cpu", dtype=dtype)
    prof = plan.profile_resnet(params, cfg, torch.empty(shape, dtype=dtype))
    assert prof.act_bytes == jprof.act_bytes
    for k in (1, 2, 3):
        assert plan.plan_min_peak(prof, k).boundaries == \
            jplan.plan_min_peak(jprof, k).boundaries


def test_profile_allocates_nothing():
    params = cnn.init_params(cnn.resnet18(), 0, device="cpu")
    x = torch.empty((4, 32, 32, 3), device="meta")
    prof = plan.profile_resnet(params, cnn.resnet18(), x)
    assert prof.total_bytes() > 0 and all(
        p.device.type == "cpu" and not p.requires_grad
        for p in params.values())


def _chain(seed, n):
    rng = np.random.default_rng(seed)
    act = [int(v) for v in rng.integers(1, 10_000, n)]
    flops = [float(v) for v in rng.integers(1, 1_000_000, n)]
    resid = [int(v) for v in rng.integers(0, 5_000, n)]
    return act, flops, resid


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("with_resid", [False, True])
def test_solvers_equal_jax_on_random_chains(seed, with_resid):
    n = 3 + seed * 3
    act, flops, resid = _chain(seed, n)
    r = resid if with_resid else None
    for k in (0, 1, 2, 4, n + 2):
        assert solver.min_peak_boundaries(act, k, resid_bytes=r) == \
            jsolver.min_peak_boundaries(act, k, resid_bytes=r)
    total = sum(act) + (sum(resid) if with_resid else 0)
    for frac in (0.05, 0.2, 0.4, 0.7, 1.1):
        assert solver.budget_boundaries(act, flops, frac * total,
                                        resid_bytes=r) == \
            jsolver.budget_boundaries(act, flops, frac * total,
                                      resid_bytes=r)
    for bounds in ([], [1], sorted({1, n // 2, n - 1})):
        assert solver.plan_metrics(act, flops, bounds, resid_bytes=r) == \
            jsolver.plan_metrics(act, flops, bounds, resid_bytes=r)
    assert solver._prefix(flops) == jsolver._prefix(flops)
    assert solver._live_prefix(act, r) == jsolver._live_prefix(act, r)


def test_pareto_equals_jax():
    rng = np.random.default_rng(5)
    states = [(int(a), int(b), (i,)) for i, (a, b) in
              enumerate(rng.integers(0, 50, (40, 2)))]
    assert solver._pareto(list(states)) == jsolver._pareto(list(states))


@pytest.mark.parametrize("budget_frac", [0.3, 0.6, 2.0, 0.01])
def test_plan_for_budget_and_report_equal_jax(budget_frac):
    act, flops, resid = _chain(11, 12)
    prof = plan.ChainProfile(tuple(act), tuple(flops),
                             tuple(f"l{i}" for i in range(12)), tuple(resid))
    jprof = jplan.ChainProfile(tuple(act), tuple(flops),
                               tuple(f"l{i}" for i in range(12)),
                               tuple(resid))
    budget = budget_frac * (sum(act) + sum(resid))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mine = plan.plan_for_budget(prof, budget)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        theirs = jplan.plan_for_budget(jprof, budget)
    assert mine.to_json() == theirs.to_json()
    assert len(w) == len(jw) == (1 if ":infeasible" in mine.source else 0)
    assert plan.plan_report(prof, mine) == jplan.plan_report(jprof, theirs)


def test_chain_profile_json_round_trip_and_checks():
    prof = plan.ChainProfile((1, 2), (3.0, 4.0), ("a", "b"), (5, 6))
    back = plan.ChainProfile.from_json(prof.to_json())
    assert back == prof
    assert json.loads(prof.to_json()) == json.loads(
        jplan.ChainProfile((1, 2), (3.0, 4.0), ("a", "b"), (5, 6)).to_json())
    assert prof.resid_or_none == (5, 6)
    assert plan.ChainProfile((1,), (1.0,)).resid_or_none is None
    with pytest.raises(ValueError, match="mismatch"):
        plan.ChainProfile((1, 2), (1.0,))
    with pytest.raises(ValueError, match="mismatch"):
        plan.ChainProfile((1, 2), (1.0, 2.0), (), (1,))


# --------------------------------------------------------------------------
# The transformer half: byte arithmetic exactly as JAX's; FLOPs as JAX's at
# JAX's geometry (tile 128, S a multiple of 128) and as the port's kernel
# counters at the port's own (tile 64).
# --------------------------------------------------------------------------
# llama3-8b's smoke configuration as it is, with one KV head, and windowed
LLAMA_VARIANTS = {"as_is": {}, "n_kv1": {"n_kv": 1}, "window16": {"window": 16}}
SHAPES = [(1, 32), (2, 100), (3, 256), (1, 512)]


def _cfgs(**kw):
    """(JAX config on its flash path, port config) for llama3-8b smoke."""
    jcfg = dataclasses.replace(jconfigs.smoke_config("llama3-8b"),
                               attn_backend="interpret", **kw)
    return jcfg, dataclasses.replace(configs.smoke_config("llama3-8b"), **kw)


#: the capacity report's mesh fields with no mesh
MESH_FIELDS = {"devices": 1, "model_shards": 1, "kv_shard": "none"}


def _jax_capacity(*args, **kw):
    """The JAX package's serve_capacity_report, whole; with no mesh its
    mesh fields hold their no-mesh constants (``tests/test_torch_mesh.py``
    holds the report on meshes)."""
    rep = jplan.serve_capacity_report(*args, **kw)
    assert {k: rep[k] for k in MESH_FIELDS} == MESH_FIELDS
    return rep


def _profiles(jcfg, cfg, b, s, **kw):
    jp = jplan.profile_transformer(
        jcfg, {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}, **kw)
    tp = plan.profile_transformer(
        cfg, {"tokens": torch.empty((b, s), dtype=torch.int32,
                                    device="meta")}, **kw)
    return jp, tp


@pytest.fixture
def jax_tiles(monkeypatch):
    """The port's planner at the TPU kernels' 128 x 128 tiles: a test
    seam on the tile geometry, nothing a user sets."""
    monkeypatch.setattr(flash_ops, "BQ", 128)
    monkeypatch.setattr(flash_ops, "BK", 128)


@pytest.mark.parametrize("variant", sorted(LLAMA_VARIANTS))
@pytest.mark.parametrize("b,s", SHAPES)
def test_transformer_bytes_and_labels_equal_jax(variant, b, s):
    jcfg, cfg = _cfgs(**LLAMA_VARIANTS[variant])
    for kw in ({}, {"dtype_bytes": 4}, {"dtype_bytes": 4,
                                         "flash_resid_bytes": 2}):
        jp, tp = _profiles(jcfg, cfg, b, s, **kw)
        assert tp.act_bytes == jp.act_bytes
        assert tp.resid_bytes == jp.resid_bytes
        assert tp.labels == jp.labels
    for ctx in (s, 16):             # the JAX flash path ignores ctx too
        assert plan.attn_resid_bytes(cfg, b, s) == \
            jplan.attn_resid_bytes(jcfg, b, s, ctx)
    assert plan.kv_cache_report(cfg, b, s) == jplan.kv_cache_report(jcfg, b, s)


@pytest.mark.parametrize("variant", sorted(LLAMA_VARIANTS))
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("s_max,budget,params", [
    (64, 10**6, 0), (128, 3 * 10**5, 10**4), (1000, 12345, 0)])
def test_serve_capacity_report_equals_jax(variant, quantized, s_max, budget,
                                          params):
    jcfg, cfg = _cfgs(**LLAMA_VARIANTS[variant])
    kw = dict(quantized=quantized, params_bytes=params)
    assert plan.serve_capacity_report(cfg, s_max, budget, **kw) == \
        _jax_capacity(jcfg, s_max, budget, **kw)


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_ssm_capacity_and_carry_equal_jax(arch):
    """The SSM family's slot bytes (conv tail + state) and carry bytes."""
    jcfg = jconfigs.smoke_config(arch)
    cfg = configs.smoke_config(arch)
    assert plan.serve_capacity_report(cfg, 64, 10**6) == \
        _jax_capacity(jcfg, 64, 10**6)
    jp, tp = _profiles(jcfg, cfg, 2, 64)
    assert tp.act_bytes == jp.act_bytes and tp.labels == jp.labels
    assert plan.kv_cache_report(cfg, 2, 64) == jplan.kv_cache_report(
        jcfg, 2, 64)


@pytest.mark.parametrize("variant", sorted(LLAMA_VARIANTS))
@pytest.mark.parametrize("b,s", [(1, 128), (2, 256), (1, 512)])
def test_transformer_flops_equal_jax_at_jax_tiles(jax_tiles, variant, b, s):
    jcfg, cfg = _cfgs(**LLAMA_VARIANTS[variant])
    jp, tp = _profiles(jcfg, cfg, b, s)
    assert tp.flops == jp.flops
    assert plan.flash_bwd_recompute_flops(cfg, b, s) == \
        jplan.flash_bwd_recompute_flops(jcfg, b, s)
    assert plan.flash_attn_flop_report(cfg, b, s) == \
        jplan.flash_attn_flop_report(jcfg, b, s)


@pytest.mark.parametrize("window", [0, 16, 100])
@pytest.mark.parametrize("s", [1, 50, 64, 100, 128, 300])
def test_tile_counts_equal_the_kernel_counters(window, s):
    """At the port's own 64 x 64 tiles the planner counts what the
    kernels' counters count, ragged S included."""
    cfg = dataclasses.replace(configs.smoke_config("llama3-8b"),
                              window=window)
    g = cfg.n_heads // cfg.n_kv
    for c in plan.profile._flash_tile_counts(cfg, s):
        assert c["bq"] == c["bk"] == flash_ops.BQ == 64
        fwd = flash_ops.expected_counts(s, window=window)
        dq, dkv = flash_ops.expected_bwd_counts(s, g, window=window)
        assert c["fwd"] == sum(fwd) and c["dq"] == sum(dq)
        assert g * c["dkv"] == sum(dkv)
    rep = plan.flash_attn_flop_report(cfg, 1, s)
    bhd = cfg.n_heads * cfg.head_dim * 64 * 64
    assert rep["visited_flops"] == cfg.n_layers * bhd * (
        4.0 * sum(fwd) + 6.0 * sum(dq) + 8.0 * sum(dkv) / g)


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("lengths", [None, [5, 1024, 333], [1, 1, 1024]])
@pytest.mark.parametrize("variant", sorted(LLAMA_VARIANTS))
def test_decode_tile_report_equals_jax(variant, lengths, splits):
    jcfg, cfg = _cfgs(**LLAMA_VARIANTS[variant])
    assert plan.decode_tile_report(cfg, 3, 1024, lengths=lengths,
                                   splits=splits) == \
        jplan.decode_tile_report(jcfg, 3, 1024, lengths=lengths,
                                 splits=splits)


def test_hymba_eligibility_differs_from_jax_on_purpose():
    """The JAX package sends hymba's global layers down its jnp path
    (O(S^2) probabilities); the port runs them through the flash op, so
    it budgets flash residuals there: a known difference, pinned."""
    jcfg = dataclasses.replace(jconfigs.smoke_config("hymba-1.5b"),
                               attn_backend="interpret")
    cfg = configs.smoke_config("hymba-1.5b")
    assert plan.flash_training_eligible(cfg, 64)
    assert not jplan.flash_training_eligible(jcfg, 64)
    jp, tp = _profiles(jcfg, cfg, 2, 64)
    assert tp.act_bytes == jp.act_bytes
    flash = plan.attn_resid_bytes(cfg, 2, 64)
    assert tp.resid_bytes == (flash,) * cfg.n_layers
    assert flash < jp.resid_bytes[0]
    # the SSM family has no attention: neither package is eligible
    assert not plan.flash_training_eligible(
        configs.smoke_config("mamba2-130m"), 64)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [1, 2, 3])
def test_optimal_segments_equals_jax(seed, k):
    rng = np.random.default_rng(seed)
    acts = [int(x) for x in rng.integers(1, 10_000, int(rng.integers(4, 12)))]
    assert ckpt.optimal_segments(acts, k) == jckpt.optimal_segments(acts, k)


def test_activation_bytes_of_equals_jax():
    x = np.zeros((3, 5, 7), np.float32)

    def jfn(a):
        return {"y": (a @ jnp.ones((7, 4))).astype(jnp.bfloat16),
                "s": a.sum(-1)}

    def fn(a):
        return {"y": (a @ torch.ones((7, 4), device=a.device)).to(
            torch.bfloat16), "s": a.sum(-1)}
    assert ckpt.activation_bytes_of(fn, torch.from_numpy(x)) == \
        jckpt.activation_bytes_of(jfn, jnp.asarray(x))
