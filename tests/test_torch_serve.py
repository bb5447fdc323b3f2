"""The port's serving engine against the JAX package's: the same smoke
weights (bridged), the same seeded trace, greedy under the f32 policy ->
identical tokens for every request, with full-causal and with windowed
(dense-bias decode) attention; the slot-pool invariants; the memory
budget's slot clamp, as the JAX engine computes it; and the CLI's device
handling, engine and lockstep, the SSM family included, and its
``--mem-budget-mb``."""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.serve import ServeEngine as JServeEngine
from repro.serve import synthetic_trace as jsynthetic_trace
from repro_torch import configs
from repro_torch.models import bridge
from repro_torch.serve import (ServeEngine, SlotPool, scatter_request,
                               synthetic_trace)

torch.set_num_threads(2)
TRACE_KW = dict(vocab=256, mean_prompt=12, max_prompt=32, mean_gen=8,
                max_gen=32)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runs():
    jcfg = jconfigs.smoke_config("llama3-8b")
    cfg = configs.smoke_config("llama3-8b")
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    model = bridge.load_jax_params(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    kw = dict(max_slots=4, max_len=64, policy_name="full")
    jeng = JServeEngine(params, jcfg, kv_backend="ref", **kw)
    jeng.warmup()
    jsum = jeng.run(jsynthetic_trace(8, seed=0, **TRACE_KW))
    eng = ServeEngine(model, cfg, **kw)
    eng.warmup()
    trace = synthetic_trace(8, seed=0, **TRACE_KW)
    summ = eng.run(trace)
    return jeng, jsum, eng, summ, trace


def test_windowed_engine_matches_jax_engine():
    # a uniform sliding window is engine-eligible on both sides: prefill
    # through the windowed flash op, decode through the dense band bias
    jcfg = dataclasses.replace(jconfigs.smoke_config("llama3-8b"), window=16)
    cfg = dataclasses.replace(configs.smoke_config("llama3-8b"), window=16)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(1))
    model = bridge.load_jax_params(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    kw = dict(max_slots=3, max_len=64, policy_name="full")
    jeng = JServeEngine(params, jcfg, kv_backend="ref", **kw)
    jsum = jeng.run(jsynthetic_trace(5, seed=2, **TRACE_KW))
    eng = ServeEngine(model, cfg, **kw)
    summ = eng.run(synthetic_trace(5, seed=2, **TRACE_KW))
    assert summ["n_done"] == jsum["n_done"] == 5
    assert max(len(r.prompt) + len(r.tokens) for r in eng._requests_done) \
        > 16                                   # decode went past the window
    want = {r.rid: r.tokens for r in jeng._requests_done}
    got = {r.rid: r.tokens for r in eng._requests_done}
    assert got == want


def test_trace_is_shared():
    a = synthetic_trace(5, seed=3, **TRACE_KW)
    b = jsynthetic_trace(5, seed=3, **TRACE_KW)
    for x, y in zip(a, b):
        assert x.arrival_step == y.arrival_step
        assert x.max_new_tokens == y.max_new_tokens
        np.testing.assert_array_equal(x.prompt, y.prompt)


def test_greedy_tokens_match_jax_engine(runs):
    jeng, jsum, eng, summ, trace = runs
    assert summ["n_done"] == jsum["n_done"] == len(trace)
    want = {r.rid: r.tokens for r in jeng._requests_done}
    got = {r.rid: r.tokens for r in eng._requests_done}
    assert got == want
    assert summ["n_steps"] == jsum["n_steps"]


def test_no_slot_leak(runs):
    _, _, eng, summ, trace = runs
    pool = eng.pool
    assert pool.occupancy == 0 and pool.allocs == pool.frees == len(trace)
    assert pool.audit()["free"] == pool.max_slots
    assert summ["n_faults"] == 0 and not summ["stalled"]
    diag = summ["diagnostics"]
    assert diag["prefills"] == len(trace)
    # on the CPU the plain versions run: no kernel was launched
    assert diag["kernel_launches"] == {"flash_fwd": 0, "flash_fwd_sm90": 0,
                                       "flash_decode": 0,
                                       "flash_decode_bias": 0}


def test_scatter_request_in_place():
    cfg = configs.smoke_config("llama3-8b")
    pool = SlotPool(cfg, 3, 16, device="cpu")
    before = pool.cache["k"].data_ptr()
    req = {name: torch.full_like(pool.cache[name][:, :1], 7)
           for name in ("k", "v", "k_scale", "v_scale")}
    scatter_request(pool.cache, req, 1, 5)
    assert pool.cache["k"].data_ptr() == before
    assert (pool.cache["k"][:, 1] == 7).all()
    assert (pool.cache["k"][:, 0] == 0).all()
    assert pool.cache["pos"].tolist() == [0, 5, 0]
    with pytest.raises(ValueError, match="grow"):
        scatter_request(pool.cache, {n: t[:, :, :, :4]
                                     for n, t in req.items()}, 0, 1)


def test_sentinel_quarantines_and_replays():
    cfg = configs.smoke_config("llama3-8b")
    from repro_torch.models import transformer
    model = transformer.init_params(cfg, 0, device="cpu")
    eng = ServeEngine(model, cfg, max_slots=2, max_len=48,
                      policy_name="full")
    poisoned = []

    def poison(engine):
        # a dropped scatter leaves pos 0: the sentinel must trip on it
        if not poisoned and engine._slot_req:
            slot = next(iter(engine._slot_req))
            engine.pool.cache["pos"][slot] = 0
            poisoned.append(slot)

    eng.hooks["pre_decode"] = poison
    summ = eng.run(synthetic_trace(3, seed=1, **TRACE_KW | {"max_prompt": 16,
                                                           "max_gen": 16}))
    assert poisoned and summ["n_faults"] == 1 and summ["n_retried"] == 1
    assert summ["n_done"] == 3
    assert eng.pool.allocs == eng.pool.frees


def _cli(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)


def test_cli_engine_on_cpu():
    out = _cli("--device", "cpu", "--smoke", "--engine", "--requests", "6")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "kernel launches" in out.stdout


def test_cli_refuses_without_a_card():
    out = _cli("--smoke", "--engine", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "--device cpu" in out.stderr


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_cli_lockstep_ssm_on_cpu(arch):
    out = _cli("--device", "cpu", "--smoke", "--arch", arch, "--gen", "24")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ms/tok" in out.stdout and "tok/s" in out.stdout
    assert "prefill 4x64" in out.stdout
    if arch == "mamba2-130m":
        assert "n/a (no kvq-layout attention cache)" in out.stdout
    refused = _cli("--device", "cpu", "--smoke", "--arch", arch, "--engine")
    assert refused.returncode == 2
    assert "not engine-eligible" in refused.stdout
    no_card = _cli("--smoke", "--arch", arch,
                   env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert no_card.returncode != 0 and "--device cpu" in no_card.stderr


# --------------------------------------------------------------------------
# The serve memory budget: the JAX engine's capacity arithmetic.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("slots_in_budget", [1.0, 2.5, 3.99, 9.0])
def test_budget_clamps_slots_as_the_jax_engine(window, slots_in_budget):
    jcfg = dataclasses.replace(jconfigs.smoke_config("llama3-8b"),
                               window=window)
    cfg = dataclasses.replace(configs.smoke_config("llama3-8b"),
                              window=window)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    model = bridge.load_jax_params(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    kw = dict(max_slots=4, max_len=64, policy_name="full")
    per_slot = SlotPool(cfg, 1, 64, device="cpu").bytes_per_slot()
    budget = int(slots_in_budget * per_slot)
    jeng = JServeEngine(params, jcfg, kv_backend="ref",
                        mem_budget_bytes=budget, **kw)
    eng = ServeEngine(model, cfg, mem_budget_bytes=budget, **kw)
    # the whole report, its mesh fields at their no-mesh values
    jrep = dict(jeng.capacity_report)
    assert {k: jrep[k] for k in ("devices", "model_shards",
                                 "kv_shard")} == \
        {"devices": 1, "model_shards": 1, "kv_shard": "none"}
    assert eng.capacity_report == jrep
    assert eng.pool.max_slots == jeng.pool.max_slots == \
        min(4, int(slots_in_budget))
    assert eng.pool.bytes_per_slot_per_device() == \
        jeng.pool.bytes_per_slot_per_device() == per_slot
    assert eng.scheduler.byte_budget == budget
    # the budget holds through a trace: never more slots resident
    seen = []
    eng.hooks["pre_decode"] = lambda e: seen.append(e.scheduler.resident)
    summ = eng.run(synthetic_trace(6, seed=0, **TRACE_KW))
    assert summ["n_done"] == 6
    assert max(seen) <= eng.pool.max_slots
    eng.reset()
    assert eng.scheduler.byte_budget == budget


def test_budget_admitting_no_slot_raises():
    cfg = configs.smoke_config("llama3-8b")
    model = bridge.load_jax_params(cfg, jax.tree.map(
        np.asarray, jtf.init_params(jconfigs.smoke_config("llama3-8b"),
                                    jax.random.PRNGKey(0))), device="cpu")
    per_slot = SlotPool(cfg, 1, 64, device="cpu").bytes_per_slot()
    with pytest.raises(ValueError, match="admits 0 slots"):
        ServeEngine(model, cfg, max_slots=4, max_len=64,
                    mem_budget_bytes=per_slot - 1)


def test_cli_budget_prints_capacity():
    out = _cli("--device", "cpu", "--smoke", "--engine", "--requests", "6",
               "--max-slots", "4", "--mem-budget-mb", "0.05")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "capacity: 0.02 MB/slot at max_len=128 -> budget 0.05 MB " \
        "admits 2 of 4 requested slots" in out.stdout
    refused = _cli("--device", "cpu", "--smoke", "--engine",
                   "--mem-budget-mb", "0.01")
    assert refused.returncode != 0 and "admits 0 slots" in refused.stderr
