"""The port's replica fleet against the JAX package's on the CPU: the same
smoke weights (bridged), f32 policy, greedy, three replicas under the same
chaos seed -> the same router events (health transitions, placements,
failovers, terminals), the same ``summary()["fleet"]`` counts and the same
per-gid terminal states and tokens; a ``crash_after_appends`` sweep
recovers token-exact; the request-keyed sampler (port only) keeps a
trajectory across slot, step, co-tenants and migration, matches softmax in
a chi-square test and respects top-k; the CLI's fleet, journal,
``--recover``, ``--workers`` and ``--events / --trace / --metrics-every``."""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.obs import schema as jschema
from repro.serve import FleetFaultInjector as JFleetFaultInjector
from repro.serve import Router as JRouter
from repro.serve import ServeEngine as JServeEngine
from repro.serve import chaos_plan as jchaos_plan
from repro_torch import configs
from repro_torch.events import read_events
from repro_torch.models import bridge
from repro_torch.obs import schema
from repro_torch.serve import (DEAD, DONE, DRAINED, HEALTHY, TERMINAL,
                               BreakerConfig,
                               FleetFaultInjector, RequestJournal, Router,
                               ServeEngine, SimulatedCrash, TraceRequest,
                               chaos_plan, crash_after_appends,
                               fold_request_key, sample_tokens_per_row)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(max_slots=3, max_len=32, prompt_buckets=(16, 32),
          policy_name="full", sampler_keys="request")


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.smoke_config("llama3-8b")
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    model = bridge.load_jax_params(configs.smoke_config("llama3-8b"),
                                   jax.tree.map(np.asarray, params),
                                   device="cpu")
    return jcfg, params, model


@pytest.fixture(scope="module")
def replicas(weights):
    """Three warmed greedy replicas in each package."""
    jcfg, params, model = weights
    cfg = configs.smoke_config("llama3-8b")
    jengs = [JServeEngine(params, jcfg, kv_backend="ref", **KW)
             for _ in range(3)]
    engs = [ServeEngine(model, cfg, **KW) for _ in range(3)]
    for e in jengs + engs:
        e.warmup()
    return jengs, engs


def _reset(engines):
    for e in engines:
        e.reset()
        e.hooks.clear()
    return engines


class ListSink:
    def __init__(self):
        self.records = []

    def emit(self, kind, **fields):
        self.records.append((kind, fields))


def _trace(n=10, seed=7, spread=6):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 256, size=int(rng.integers(4, 10)))
               .astype(np.int32) for _ in range(n)]
    return [TraceRequest(arrival_step=int(rng.integers(0, spread + 1)),
                         prompt=p, max_new_tokens=int(rng.integers(5, 10)))
            for p in prompts]


def _drive(router, guard=600):
    while router.live_requests() > 0 and guard:
        router.step()
        guard -= 1
    assert guard, "fleet failed to drain"


def _chaos_run(router_cls, inj_cls, plan_fn, engines, seed):
    sink = ListSink()
    breaker = BreakerConfig(window_steps=8, stall_steps=3, cooldown_steps=4)
    router = router_cls(_reset(engines), breaker=breaker, sink=sink)
    plan = plan_fn(seed, steps=14, replicas=3, n_events=4)
    inj = inj_cls(router, plan)
    summary = router.run(_trace())
    ledger = {g: (fr.state, list(fr.tokens), fr.migrations)
              for g, fr in router._reqs.items()}
    return summary, sink.records, ledger, dict(inj.injected)


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_chaos_fleet_equals_the_jax_fleet(replicas, seed):
    jengs, engs = replicas
    want = _chaos_run(JRouter, JFleetFaultInjector, jchaos_plan, jengs, seed)
    got = _chaos_run(Router, FleetFaultInjector, chaos_plan, engs, seed)
    summary, events, ledger, injected = got
    assert summary["fleet"] == want[0]["fleet"]
    assert summary["health"] == want[0]["health"]
    assert summary["time_in_quarantine"] == want[0]["time_in_quarantine"]
    assert events == want[1]          # health transitions, placements, ...
    assert ledger == want[2]
    assert injected == want[3] and injected
    assert summary["reconcile"]["ok"] and not summary["stalled"]
    assert all(st in TERMINAL for st, _, _ in ledger.values())
    for e in engs:
        assert e.pool.occupancy == 0 and e.pool.allocs == e.pool.frees
    assert sum(summary["fleet"][k] for k in (
        "n_done", "n_cancelled", "n_dropped", "n_failed")) == len(_trace())


def test_chaos_seeds_exercise_failover(replicas):
    """Across the parametrized seeds the fleet lost replicas and moved
    requests (so the equalities above cover the failover paths)."""
    _, engs = replicas
    kinds, moved = set(), 0
    for seed in (0, 3, 5):
        summary, events, _, injected = _chaos_run(
            Router, FleetFaultInjector, chaos_plan, engs, seed)
        kinds |= set(injected)
        moved += summary["fleet"]["n_migrations"]
        assert any(k == "health" for k, _ in events)
    assert kinds == {"replica_crash", "replica_sick", "replica_slow"}
    assert moved > 0


def test_drain_rejoin_and_kill(replicas):
    _, engs = replicas
    router = Router(_reset(engs))
    gids = [router.submit(t.prompt, t.max_new_tokens) for t in _trace(6)]
    router.drain_replica(2)
    while router.health[2] != DRAINED:
        router.step()
    router.rejoin(2)
    assert router.health[2] == HEALTHY
    assert router.kill(1) and not router.kill(1)
    assert router.health[1] == DEAD
    _drive(router)
    assert all(router.request(g).state == DONE for g in gids)
    assert router.reconcile()["ok"]
    with pytest.raises(ValueError, match="only DRAINED"):
        router.rejoin(0)


def test_router_refuses_step_keyed_sampling(weights):
    _, _, model = weights
    eng = ServeEngine(model, configs.smoke_config("llama3-8b"), max_slots=2,
                      max_len=32, temperature=0.7, policy_name="full")
    with pytest.raises(ValueError, match="sampler_keys='request'"):
        Router([eng])


# --------------------------------------------------------------------------
# Whole-router crash recovery at a sweep of journal appends.
# --------------------------------------------------------------------------
def _journaled(engines, path, crash_at=None):
    j = RequestJournal(path, fsync=False)
    if crash_at is not None:
        crash_after_appends(j, crash_at)
    router = Router(_reset(engines), journal=j)
    try:
        router.run(_trace(8, seed=11))
    except SimulatedCrash:
        pass
    return router, j


@pytest.mark.parametrize("crash_at", [1, 9, 27, 48])
def test_crash_after_appends_sweep_recovers_token_exact(replicas, tmp_path,
                                                        crash_at):
    _, engs = replicas
    ref_router, j = _journaled(engs, str(tmp_path / "ref.jsonl"))
    j.close()
    ref = {g: list(fr.tokens) for g, fr in ref_router._reqs.items()}
    assert len(ref) == 8 and all(fr.state == DONE
                                 for fr in ref_router._reqs.values())
    path = str(tmp_path / "wal.jsonl")
    crashed, j = _journaled(engs, path, crash_at)
    assert crashed.live_requests() > 0 or len(crashed._reqs) < 8
    j.close()                                # kill -9: the engines' state
    for e in engs:                           # vanishes with the router
        for rid, st in list(e.request_states().items()):
            if st["state"] not in TERMINAL:
                e.evict_request(rid)
    j2 = RequestJournal(path, fsync=False)
    router = Router(_reset(engs), journal=j2)
    n_live = j2.state.n_live
    info = router.recover()
    assert info["n_recovered"] == n_live == len(router._reqs) > 0
    _drive(router)
    for g, fr in router._reqs.items():
        assert fr.state == DONE and fr.tokens == ref[g], f"gid {g}"
    rec = router.reconcile()
    assert rec["ok"] and rec["journal"]["n_live"] == 0
    assert router.summary()["fleet"]["recovery_replay_success"] == 1.0
    j2.close()


# --------------------------------------------------------------------------
# The request-keyed sampler (port only: not jax.random's numbers).
# --------------------------------------------------------------------------
SAMPLED = dict(KW, temperature=0.8, top_k=5, seed=13)


@pytest.fixture(scope="module")
def sampled(weights):
    _, _, model = weights
    cfg = configs.smoke_config("llama3-8b")
    out = [ServeEngine(model, cfg, **SAMPLED) for _ in range(2)]
    for e in out:
        e.warmup()
    return out


def _finish(eng, rid, guard=200):
    while eng._requests[rid].state not in TERMINAL and guard:
        eng.step()
        guard -= 1
    return list(eng._requests[rid].tokens)


def test_trajectory_independent_of_slot_step_and_cotenants(sampled):
    a, b = _reset(sampled)
    prompt = np.arange(3, 11, dtype=np.int32)
    alone = _finish(a, a.submit(prompt, 12, key_id=77))
    # b: two co-tenants first, so the request lands in another slot at a
    # later step beside other rows
    for p in (np.arange(20, 29), np.arange(40, 45)):
        b.submit(p.astype(np.int32), 12)
    for _ in range(2):
        b.step()
    rid = b.submit(prompt, 12, key_id=77)
    crowded = _finish(b, rid)
    assert b._requests[rid].slot is None and crowded == alone
    other = _finish(a, a.submit(prompt, 12, key_id=78))
    assert other != alone                     # the key, not the prompt
    assert len(set(alone)) > 1                # it sampled, not argmax


def test_migration_keeps_the_sampled_trajectory(sampled):
    a, b = _reset(sampled)
    prompt = np.arange(5, 14, dtype=np.int32)
    want = _finish(a, a.submit(prompt, 12, key_id=5))
    _reset(sampled)
    rid = a.submit(prompt, 12, key_id=5)
    for _ in range(4):
        a.step()
    req = a.evict_request(rid)
    b.submit(np.arange(30, 36, dtype=np.int32), 6)      # a co-tenant
    b.step()
    new = b.submit(prompt, 12, key_id=5, emitted=req.tokens, front=True)
    assert _finish(b, new) == want


def test_step_keys_fix_a_run_but_not_its_placement(weights):
    """"step" keys (the engine's default): the same engine replays a run
    draw for draw after ``reset``, but the draws follow the sampler call
    and the row, so a co-tenant moves them.  ``post_logits`` sees every
    sampling, and the scores it gets pick the emitted tokens."""
    _, _, model = weights
    eng = ServeEngine(model, configs.smoke_config("llama3-8b"),
                      **dict(SAMPLED, sampler_keys="step"))
    eng.warmup()
    prompt = np.arange(3, 11, dtype=np.int32)
    picked = []
    eng.hooks["post_logits"] = lambda e, logits, scores, rows: picked.append(
        ({r: q.rid for r, q in rows.items()}, scores.argmax(-1).tolist()))
    rid = eng.submit(prompt, 12)
    first = _finish(eng, rid)
    assert picked[0] == ({0: rid}, [first[0]])          # the first token
    assert [p[1][0] for p in picked[1:]] == first[1:]   # slot 0 each round
    assert all(rows == {0: rid} for rows, _ in picked[1:])
    eng.hooks.clear()
    _reset([eng])
    assert _finish(eng, eng.submit(prompt, 12)) == first
    _reset([eng])
    eng.submit(np.arange(20, 29, dtype=np.int32), 12)
    eng.step()
    assert _finish(eng, eng.submit(prompt, 12)) != first
    assert len(set(first)) > 1                # it sampled, not argmax


def _chi2(counts, probs):
    n = counts.sum()
    return float(((counts - n * probs) ** 2 / (n * probs)).sum())


def test_request_keys_sample_the_softmax():
    """30,000 draws of one row over a 6-token vocab: Pearson's chi-square
    against softmax(logits / T) stays under 20.52, the 0.999 quantile of
    chi-square with 5 degrees of freedom; top-k 3 draws only the top 3
    and matches their renormalized softmax under 13.82 (2 dof)."""
    logits = torch.tensor([[1.0, 0.2, -0.5, 2.0, 0.0, 1.5]])
    t, n = 0.8, 30_000
    keys = fold_request_key(13, 4, torch.arange(n, dtype=torch.int64))
    toks = sample_tokens_per_row(logits.expand(n, 6), keys, temperature=t)
    probs = torch.softmax(logits[0] / t, -1).double().numpy()
    counts = np.bincount(toks.numpy(), minlength=6)
    assert _chi2(counts, probs) < 20.52
    top = sample_tokens_per_row(logits.expand(n, 6), keys, temperature=t,
                                top_k=3)
    assert set(top.tolist()) == {0, 3, 5}
    sub = probs[[0, 3, 5]] / probs[[0, 3, 5]].sum()
    assert _chi2(np.bincount(top.numpy(), minlength=6)[[0, 3, 5]], sub) \
        < 13.82


def test_request_keys_are_pure_and_row_independent():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(5, 50, generator=g)
    kids = torch.tensor([3, 9, 3, 100, 2**40 + 7])
    draws = torch.tensor([0, 4, 0, 7, 1])
    keys = fold_request_key(1, kids, draws)
    assert keys.tolist() == [fold_request_key(1, int(k), int(d))
                             for k, d in zip(kids, draws)]
    rows = sample_tokens_per_row(logits, keys, temperature=1.0)
    for i in range(5):                 # a row alone draws what it drew
        one = sample_tokens_per_row(logits[i:i + 1], keys[i:i + 1],
                                    temperature=1.0)
        assert int(one) == int(rows[i])
    assert rows[0] == rows[2] or not torch.equal(logits[0], logits[2])
    assert torch.equal(sample_tokens_per_row(logits, keys),
                       logits.argmax(-1).int())           # greedy
    with pytest.raises(ValueError, match="per-row keys"):
        sample_tokens_per_row(logits, None, temperature=1.0)


# --------------------------------------------------------------------------
# The CLI's fleet: chaos + journal + trace, then --recover through a worker.
# --------------------------------------------------------------------------
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--smoke", "--engine", *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


def _tracelens(path):
    out = subprocess.run([sys.executable,
                          os.path.join(ROOT, "tools", "tracelens.py"),
                          path, "--table"], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_cli_fleet_chaos_journal_then_recover(tmp_path):
    wal, ev = str(tmp_path / "wal.jsonl"), str(tmp_path / "ev.jsonl")
    out = _cli("--replicas", "2", "--chaos-seed", "0", "--journal", wal,
               "--events", ev, "--trace", "--metrics-every", "1")
    assert "chaos: seed 0 ->" in out and "failover:" in out
    assert "outcomes: done 16 " in out
    assert schema.validate_events(ev) == set()
    assert jschema.validate_events(ev) == set()
    kinds = {r["kind"] for r in read_events(ev)}
    assert {"health", "place", "failover", "fleet_terminal", "span_begin",
            "metrics_snapshot", "mem_sample"} <= kinds
    table = _tracelens(ev)
    for name in ("fleet_req", "req", "queue", "prefill", "decode", "step",
                 "migrate", "journal_append"):
        assert name in table
    # a crash mid-run: keep the first third of the journal's records
    with open(wal) as f:
        lines = f.readlines()
    with open(wal, "w") as f:
        f.writelines(lines[:len(lines) // 3])
    os.remove(wal + ".snap")
    out = _cli("--replicas", "1", "--workers", "--journal", wal, "--recover",
               "--requests", "2")
    rebuilt = int(out.split("recover: ")[1].split()[0])
    assert rebuilt > 0 and "subprocess workers" in out
    assert f"outcomes: done {rebuilt + 2} " in out


def test_cli_engine_events_trace_metrics(tmp_path):
    ev = str(tmp_path / "ev.jsonl")
    out = _cli("--requests", "6", "--events", ev, "--trace",
               "--metrics-every", "1")
    assert "trace: span records" in out
    assert schema.validate_events(ev) == set()
    spans = [r for r in read_events(ev, "span_begin")]
    assert sum(r["name"] == "req" for r in spans) == 6
    assert "decode" in _tracelens(ev)
    with pytest.raises(AssertionError):
        _cli("--replicas", "2", "--recover")
