"""The port's fault harness against the JAX package's on the CPU: the same
smoke weights (bridged), f32 policy, greedy, the same ``FaultPlan``
(``nan_logits``, ``corrupt_row``, ``drop_scatter``, ``cancel``) -> the
same per-request states, tokens and retries in both engines;
``evict_request`` then ``submit(emitted=)`` equals an uninterrupted run;
``chaos_plan`` equal event for event for seeds 0-9; ``poison_slot`` writes
the pool in place."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import ServeEngine as JServeEngine
from repro.serve import faults as jfaults
from repro_torch import configs
from repro_torch.models import bridge
from repro_torch.serve import (CANCELLED, DONE, FAILED, MIGRATED,
                               FaultEvent, FaultInjector, FaultPlan,
                               ServeEngine, chaos_plan, faults, poison_slot)

torch.set_num_threads(2)
KW = dict(max_slots=3, max_len=32, policy_name="full", max_retries=2)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine), same weights, warmed."""
    jcfg = jconfigs.smoke_config("llama3-8b")
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    model = bridge.load_jax_params(configs.smoke_config("llama3-8b"),
                                   jax.tree.map(np.asarray, params),
                                   device="cpu")
    jeng = JServeEngine(params, jcfg, kv_backend="ref", **KW)
    eng = ServeEngine(model, configs.smoke_config("llama3-8b"), **KW)
    for e in (jeng, eng):
        e.warmup()
    return jeng, eng


def _fresh(*engs):
    for e in engs:
        e.reset()
        e.hooks.clear()
        e.max_retries = 2
    return engs


def _prompts(n, seed=0, lo=4, hi=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _drain(eng, guard=400):
    while eng.scheduler.has_work() and guard:
        eng.step()
        guard -= 1
    assert guard, "engine failed to drain"


def _ledger(eng):
    return {rid: (r.state, list(r.tokens), r.retries)
            for rid, r in eng._requests.items()}


def _plan(mod, rids):
    return (mod.FaultPlan()
            .drop_scatter(2, rid=rids[2])
            .nan_logits(3, rid=rids[0])
            .corrupt_row(4, rid=rids[1])
            .cancel(5, rid=rids[4]))


def test_fault_plan_gives_the_jax_engines_ledger(engines):
    jeng, eng = _fresh(*engines)
    prompts = _prompts(5, seed=1)
    got = {}
    for mod, e, inj_cls in ((jfaults, jeng, JFaultInjector),
                            (faults, eng, FaultInjector)):
        rids = [e.submit(p, 6) for p in prompts]
        inj = inj_cls(e, _plan(mod, rids))
        _drain(e)
        s = e.summary()
        got[mod] = (_ledger(e), dict(inj.injected), sorted(inj.victims),
                    {k: s[k] for k in ("n_done", "n_faults", "n_retried",
                                       "n_cancelled", "n_failed")})
        assert e.pool.allocs == e.pool.frees and e.pool.occupancy == 0
    assert got[faults] == got[jfaults]
    ledger, injected, _, counts = got[faults]
    assert injected == {"drop_scatter": 1, "nan_logits": 1,
                        "corrupt_row": 1, "cancel": 1}
    assert counts["n_faults"] == counts["n_retried"] == 3
    assert [st for st, _, _ in ledger.values()].count(CANCELLED) == 1


def test_faulted_requests_replay_token_exact(engines):
    """The victims' tokens equal a fault-free run's (the faulted round's
    token is never emitted; the replay prefills prompt + healthy tokens)."""
    (eng,) = _fresh(engines[1])
    prompts = _prompts(3, seed=2)
    for p in prompts:
        eng.submit(p, 6)
    _drain(eng)
    ref = {rid: r.tokens for rid, r in eng._requests.items()}
    _fresh(eng)
    rids = [eng.submit(p, 6) for p in prompts]
    FaultInjector(eng, FaultPlan().drop_scatter(2, rid=rids[2])
                  .nan_logits(3, rid=rids[0]).corrupt_row(4, rid=rids[1]))
    _drain(eng)
    assert {rid: r.tokens for rid, r in eng._requests.items()} == ref
    assert eng.pool.quarantines == 3 and eng.pool.quarantined == 0
    eng.pool.audit()


def test_retry_budget_exhausts_to_failed_as_in_jax(engines):
    jeng, eng = _fresh(*engines)
    prompts = _prompts(2, seed=3)
    got = {}
    for mod, e, inj_cls in ((jfaults, jeng, JFaultInjector),
                            (faults, eng, FaultInjector)):
        rids = [e.submit(p, 5) for p in prompts]
        plan = mod.FaultPlan()
        for step in range(1, 40):                # poison rid 0 forever
            plan.nan_logits(step, rid=rids[0])
        inj = inj_cls(e, plan)
        _drain(e)
        got[mod] = (_ledger(e), dict(inj.injected))
        assert e._requests[rids[0]].fail_reason.startswith(
            "retry budget exhausted")
    assert got[faults] == got[jfaults]
    assert got[faults][0][0][0] == FAILED


@pytest.mark.parametrize("state", [MIGRATED, CANCELLED])
def test_evict_then_resubmit_with_emitted_equals_uninterrupted(engines,
                                                               state):
    jeng, eng = _fresh(*engines)
    prompts = _prompts(3, seed=4)
    for e in (jeng, eng):
        for p in prompts:
            e.submit(p, 7)
        _drain(e)
    ref = {rid: r.tokens for rid, r in eng._requests.items()}
    assert ref == {rid: r.tokens for rid, r in jeng._requests.items()}
    for e in _fresh(jeng, eng):
        rids = [e.submit(p, 7) for p in prompts]
        for _ in range(3):
            e.step()
        req = e.evict_request(rids[1], state)
        assert req.state == state and req.slot is None
        assert 0 < len(req.tokens) < 7
        assert e.evict_request(rids[1]) is None      # already terminal
        new = e.submit(prompts[1], 7, front=True, key_id=rids[1],
                       emitted=req.tokens)
        _drain(e)
        assert e._requests[new].state == DONE
        assert e._requests[new].tokens == ref[rids[1]]
        st = e.request_states()
        assert st[rids[1]]["state"] == state and st[new]["slot"] is None
        assert e.pool.allocs == e.pool.frees and e.pool.occupancy == 0
    with pytest.raises(ValueError, match="leaves no tokens"):
        eng.submit(prompts[0], 2, emitted=[1, 2])


def test_engine_tracer_spans_on_the_host(engines):
    from repro_torch.obs import Tracer
    (eng,) = _fresh(engines[1])
    recs = []

    class ListSink:
        def emit(self, kind, **fields):
            recs.append((kind, fields))

    eng.tracer = Tracer(ListSink(), pid="r0")
    assert eng.scheduler.tracer is eng.tracer
    try:
        rids = [eng.submit(p, 4) for p in _prompts(2, seed=5)]
        FaultInjector(eng, FaultPlan().nan_logits(2, rid=rids[0]))
        _drain(eng)
    finally:
        eng.tracer = None
    begins = {f["sid"]: f["name"] for k, f in recs if k == "span_begin"}
    ends = [f["sid"] for k, f in recs if k == "span_end"]
    assert sorted(ends) == sorted(begins)               # every span closed
    names = sorted(begins.values())
    assert names.count("req") == 2 and names.count("prefill") == 3
    assert names.count("step") == eng.step_no
    assert {"queue", "decode"} <= set(names)
    assert any(f.get("state") == "FAULT" for k, f in recs if k == "span_end")


def test_poison_slot_writes_the_pool_in_place(engines):
    (eng,) = _fresh(engines[1])
    cache = eng.pool.cache
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    poison_slot(eng, 1, float("nan"))
    assert {n: t.data_ptr() for n, t in cache.items()} == ptrs
    for n in ("k_scale", "v_scale"):
        assert torch.isnan(cache[n][:, 1]).all()
        assert not torch.isnan(cache[n][:, [0, 2]]).any()
    assert not torch.isnan(cache["k"].float()).any()
    eng.reset()


@pytest.mark.parametrize("seed", range(10))
def test_chaos_plan_equals_jax_event_for_event(seed):
    kw = dict(steps=16, replicas=3, n_events=6)
    got = [dataclass_tuple(e) for e in chaos_plan(seed, **kw).events]
    want = [dataclass_tuple(e)
            for e in jfaults.chaos_plan(seed, **kw).events]
    assert got == want
    with_kill = dict(kw, kinds=faults.REPLICA_KINDS + faults.WORKER_KINDS)
    assert [dataclass_tuple(e) for e in chaos_plan(seed, **with_kill).events] \
        == [dataclass_tuple(e) for e in jfaults.chaos_plan(
            seed, **dict(kw, kinds=jfaults.REPLICA_KINDS
                         + jfaults.WORKER_KINDS)).events]


def dataclass_tuple(e):
    return (e.step, e.kind, e.rid, e.slot, e.replica, e.duration)


def test_kinds_and_validation_match_jax():
    assert faults.KINDS == jfaults.KINDS
    assert faults.REPLICA_KINDS == jfaults.REPLICA_KINDS
    assert faults.WORKER_KINDS == jfaults.WORKER_KINDS
    for bad in (dict(step=0, kind="meteor"), dict(step=-1, kind="cancel",
                                                  rid=0),
                dict(step=0, kind="cancel"), dict(step=0,
                                                  kind="replica_crash")):
        with pytest.raises(ValueError):
            FaultEvent(**bad)
        with pytest.raises(ValueError):
            jfaults.FaultEvent(**bad)
    plan = FaultPlan().nan_logits(3, rid=0).cancel(3, rid=1).replica_slow(
        5, 0)
    assert len(plan) == 3 and plan.counts()["cancel"] == 1
    assert [e.kind for e in plan.at(3)] == ["nan_logits", "cancel"]
    assert plan.at(5)[0].duration == 8


def test_engine_validates_its_knobs(engines):
    model, cfg = engines[1].model, engines[1].cfg
    with pytest.raises(ValueError, match="sampler_keys"):
        ServeEngine(model, cfg, max_slots=2, max_len=32, sampler_keys="x")
    with pytest.raises(ValueError, match="retry_backoff_steps"):
        ServeEngine(model, cfg, max_slots=2, max_len=32,
                    retry_backoff_steps=-1)
    with pytest.raises(ValueError, match="exceeds max_len"):
        ServeEngine(model, cfg, max_slots=2, max_len=32,
                    prompt_buckets=(16, 64))
