"""The port's planner (``plan/solver.py``, ``plan/profile.py``) against the
JAX package's on the CPU: the ResNet chain's activation bytes (walked on
meta tensors here, with ``jax.eval_shape`` there) and the plan the
example's S-C pipeline solves, exactly; and the solvers on seeded random
chains, exactly.  FLOPs are analytic in the port (XLA's cost analysis has
no counterpart): held to be positive and within a band of XLA's count."""
from __future__ import annotations

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as jplan
from repro.models import cnn as jcnn
from repro.plan import solver as jsolver
from repro_torch import plan
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
