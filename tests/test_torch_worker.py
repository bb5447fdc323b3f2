"""The port's subprocess replicas on the CPU (``device="cpu"``): the pipe
RPC round trip, frames of numpy arrays and Python scalars only, a worker's
greedy tokens equal an in-process engine's from the same seed, a mixed
fleet (one engine, one worker) reconciles, and a SIGKILL behind the
router's back marks the worker dead, the breaker quarantines it and its
requests finish on the survivor.  Two workers are spawned in all."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.serve import (DEAD, DONE, QUARANTINED, TERMINAL,
                               AdmissionRejected, BreakerConfig, FaultPlan,
                               FleetFaultInjector, Router, ServeEngine,
                               spawn_worker, worker)

torch.set_num_threads(2)
ENGINE_KW = dict(max_slots=2, max_len=32, prompt_buckets=(16, 32),
                 policy_name="full", sampler_keys="request")
WORKER_KW = dict(device="cpu", init_seed=0, **ENGINE_KW)
NO_LAUNCHES = {"flash_fwd": 0, "flash_fwd_sm90": 0, "flash_decode": 0,
               "flash_decode_bias": 0}


@pytest.fixture(scope="module")
def worker_mod():
    """One warmed subprocess replica, shared (reset between tests)."""
    w = spawn_worker(kwargs=WORKER_KW)
    yield w
    w.shutdown()


@pytest.fixture(scope="module")
def engine():
    """An in-process engine built as ``engine_factory`` builds the
    worker's (same seed, same knobs)."""
    cfg = configs.smoke_config("llama3-8b")
    model = transformer.init_params(cfg, 0, device="cpu")
    e = ServeEngine(model, cfg, **ENGINE_KW)
    e.warmup()
    return e


def _prompts(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, size=rng.randint(4, 9)).astype(np.int32)
            for _ in range(n)]


def _finish(eng, rid, guard=60):
    while eng.request_states()[rid]["state"] not in TERMINAL and guard:
        eng.step()
        guard -= 1
    return eng.request_states()[rid]


def _drive(router, guard=600):
    while router.live_requests() > 0 and guard:
        router.step()
        guard -= 1
    assert guard, "fleet failed to drain"


def test_rpc_roundtrip(worker_mod):
    w = worker_mod
    w.reset()
    assert w.ping() and w.alive and w.pid > 0
    assert w.sampler_keys == "request" and w.temperature == 0.0
    assert w.buckets == (16, 32) and w.pool.max_slots == 2
    assert w.warmup() == NO_LAUNCHES      # the plain versions on the CPU
    rid = w.submit(np.arange(1, 6, dtype=np.int32), 4)
    st = _finish(w, rid)
    assert st["state"] == DONE and len(st["tokens"]) == 4
    assert w.heartbeat_age() < 60.0
    s = w.summary()
    assert s["n_done"] == 1 and not s.get("dead")
    assert s["diagnostics"]["kernel_launches"] == NO_LAUNCHES
    assert w.kernel_launches() == NO_LAUNCHES
    assert w.pool.allocs == w.pool.frees == 1
    w.reset()


def test_frames_hold_no_tensor(engine):
    """What the child ships (harvest snapshot, summary, request states) is
    numpy and plain Python all the way down."""
    e = engine
    e.reset()
    rid = e.submit(_prompts(1)[0], 3)
    e.step()

    def walk(x):
        assert not isinstance(x, torch.Tensor), x
        if isinstance(x, dict):
            for k, v in x.items():
                walk(k)
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            assert x is None or isinstance(
                x, (int, float, str, bool, np.generic, np.ndarray)), type(x)

    walk(worker._snapshot(e))
    walk(worker._dispatch(e, "summary", {}))
    walk(worker._dispatch(e, "evict", {"rid": rid, "state": "MIGRATED"}))
    e.reset()


def test_worker_matches_in_process_engine(worker_mod, engine):
    worker_mod.reset()
    engine.reset()
    prompt = _prompts(1, seed=3)[0]
    got = [_finish(eng, eng.submit(prompt, 6))["tokens"]
           for eng in (worker_mod, engine)]
    assert got[0] == got[1] and len(got[0]) == 6
    worker_mod.reset()
    engine.reset()


def test_mixed_fleet_runs_and_reconciles(worker_mod, engine):
    worker_mod.reset()
    engine.reset()
    router = Router([engine, worker_mod])
    gids = [router.submit(p, 4) for p in _prompts(4, seed=5)]
    _drive(router)
    assert all(router.request(g).state == DONE for g in gids)
    assert {router.request(g).placements[0][0] for g in gids} == {0, 1}
    rec = router.reconcile()
    assert rec["ok"], rec
    assert router.summary()["fleet"]["n_done"] == len(gids)
    worker_mod.reset()
    engine.reset()


def test_sigkill_midflight_breaker_fails_over(engine):
    """A worker is SIGKILLed behind the router's back mid-run: the proxy
    marks itself dead, the stall detector quarantines it, every victim
    finishes on the survivor, and the fleet reconciles with no leak."""
    engine.reset()
    ref = {}
    for i, p in enumerate(_prompts(5, seed=9)):
        ref[i] = _finish(engine, engine.submit(p, 8))["tokens"]
    engine.reset()
    w = spawn_worker(kwargs=WORKER_KW)
    router = Router([engine, w], breaker=BreakerConfig(
        window_steps=8, stall_steps=2, cooldown_steps=4))
    inj = FleetFaultInjector(router, FaultPlan().worker_sigkill(3, replica=1))
    gids = [router.submit(p, 8) for p in _prompts(5, seed=9)]
    _drive(router)
    assert inj.injected["worker_sigkill"] == 1 and not w.alive
    assert w.death_reason == "SIGKILL"
    assert router.health[1] in (QUARANTINED, DEAD)
    for g in gids:
        assert router.request(g).state == DONE
        assert router.request(g).tokens == ref[g], f"gid {g}"
    assert router.summary()["fleet"]["failovers"] >= 1
    rec = router.reconcile()
    assert rec["ok"], rec
    assert engine.pool.allocs == engine.pool.frees
    # the dead worker: rejects, reports its mirror, keeps its counters
    with pytest.raises(AdmissionRejected):
        w.submit(np.arange(1, 4, dtype=np.int32), 2)
    assert w.summary()["dead"] is True
    assert w.kernel_launches() == NO_LAUNCHES
    assert not w.terminate() and w.step() is None
    assert w._proc.poll() is not None            # the process is reaped
    engine.reset()
