"""The port's write-ahead journal against the JAX package's on the CPU: one
fleet run over the same weights and requests writes the same records in
both packages; a journal written by either loads in the other to the same
``JournalState.to_json()``, and a fleet crashed mid-run in one package
recovers in the other token-exact; snapshot + tail equals full history;
the crash harness (``crash_after_appends``, ``tear_tail``)."""
from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.serve import RequestJournal as JRequestJournal
from repro.serve import Router as JRouter
from repro.serve import ServeEngine as JServeEngine
from repro.serve import journal as jjournal
from repro_torch import configs
from repro_torch.events import read_events
from repro_torch.models import bridge
from repro_torch.serve import (DONE, TERMINAL, WAL_KINDS, JournalState,
                               RequestJournal, Router, ServeEngine,
                               SimulatedCrash, crash_after_appends,
                               load_state, tear_tail)

torch.set_num_threads(2)
KW = dict(max_slots=2, max_len=32, prompt_buckets=(16, 32),
          policy_name="full", sampler_keys="request")
MAX_NEW = 8


@pytest.fixture(scope="module")
def fleets():
    """Two warmed replicas in each package, same weights."""
    jcfg = jconfigs.smoke_config("llama3-8b")
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    model = bridge.load_jax_params(configs.smoke_config("llama3-8b"),
                                   jax.tree.map(np.asarray, params),
                                   device="cpu")
    jengs = [JServeEngine(params, jcfg, kv_backend="ref", **KW)
             for _ in range(2)]
    engs = [ServeEngine(model, configs.smoke_config("llama3-8b"), **KW)
            for _ in range(2)]
    for e in jengs + engs:
        e.warmup()
    return {"jax": (JRouter, JRequestJournal, jengs),
            "torch": (Router, RequestJournal, engs)}


def _prompts(n=6, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, size=rng.randint(4, 9)).astype(np.int32)
            for _ in range(n)]


def _force_drain(engines):
    """``kill -9`` of the router process: every engine-side request
    vanishes."""
    for e in engines:
        for rid, st in list(e.request_states().items()):
            if st["state"] not in TERMINAL:
                e.evict_request(rid)
        e.reset()


def _drive(router, guard=600):
    while router.live_requests() > 0 and guard:
        router.step()
        guard -= 1
    assert guard, "fleet failed to drain"


def _run(fleet, path, *, crash_after_steps=None):
    """A journaled fleet run over ``_prompts()``; returns gid -> tokens (or
    the live count when crashed after ``crash_after_steps`` steps)."""
    router_cls, journal_cls, engines = fleet
    for e in engines:
        e.reset()
    j = journal_cls(path, fsync=False)
    router = router_cls(engines, journal=j)
    gids = [router.submit(p, MAX_NEW) for p in _prompts()]
    if crash_after_steps is not None:
        for _ in range(crash_after_steps):
            router.step()
        n_live = router.live_requests()
        _force_drain(engines)
        j.close()
        return n_live
    _drive(router)
    j.close()
    out = {g: list(router.request(g).tokens) for g in gids}
    assert all(router.request(g).state == DONE for g in gids)
    _force_drain(engines)
    return out


def _records(path):
    return [{k: v for k, v in r.items() if k != "t"}
            for r in read_events(path)]


def test_one_fleet_run_writes_the_jax_records(fleets, tmp_path):
    paths = {k: str(tmp_path / f"{k}.jsonl") for k in fleets}
    tokens = {k: _run(fleets[k], paths[k]) for k in fleets}
    assert tokens["torch"] == tokens["jax"]
    recs = _records(paths["torch"])
    assert recs == _records(paths["jax"])
    assert {r["kind"] for r in recs} == {"wal_submit", "wal_place",
                                         "wal_tokens", "wal_terminal"}


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_crash_in_one_package_recovers_in_the_other(fleets, tmp_path,
                                                    writer, reader):
    ref = _run(fleets["torch"], str(tmp_path / "ref.jsonl"))
    path = str(tmp_path / "wal.jsonl")
    assert _run(fleets[writer], path, crash_after_steps=4) > 0
    want = jjournal.load_state(path)[0].to_json()
    assert load_state(path)[0].to_json() == want
    router_cls, journal_cls, engines = fleets[reader]
    j = journal_cls(path, fsync=False)
    assert j.state.to_json() == want
    router = router_cls([e for e in engines], journal=j)
    info = router.recover()
    assert info["n_recovered"] == len(want["live"]) > 0
    _drive(router)
    for g, toks in ref.items():
        assert router.request(g).state == DONE
        assert list(router.request(g).tokens) == toks, f"gid {g}"
    assert router.reconcile()["ok"]
    j.close()
    _force_drain(engines)


# --------------------------------------------------------------------------
def _script(j):
    j.submit(0, [1, 2, 3], 4, None, None)
    j.place(0, 0, 0, front=False, emitted=0)
    j.tokens(0, 0, [5, 6])
    j.submit(1, [7], 3, 2, 9)
    j.migrate(0, "replica 0 crashed")
    j.tokens(0, 1, [6, 8])
    j.terminal(1, "CANCELLED")
    j.submit(2, [4, 4], 2, None, None)
    j.terminal(0, "DONE", n_tokens=3)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_loads_in_both_packages_to_one_state(tmp_path, writer):
    path = str(tmp_path / "wal.jsonl")
    cls = JRequestJournal if writer == "jax" else RequestJournal
    with cls(path) as j:
        _script(j)
        live = j.state.to_json()
    assert load_state(path)[0].to_json() == live
    assert jjournal.load_state(path)[0].to_json() == live
    assert live["live"] == {"2": {"prompt": [4, 4], "max_new_tokens": 2,
                                  "eos_id": None, "deadline_steps": None,
                                  "tokens": [], "migrations": 0,
                                  "placements": 0}}
    assert live["terminal_counts"] == {"CANCELLED": 1, "DONE": 1}
    assert live["goodput_tokens"] == 3


def test_reducer_equals_jax_record_by_record():
    st, jst = JournalState(), jjournal.JournalState()

    class Both:
        def _append(self, kind, **rec):
            st.apply(kind, rec)
            jst.apply(kind, rec)
            assert st.to_json() == jst.to_json()

    both = Both()
    for name in ("submit", "place", "tokens", "migrate", "terminal"):
        setattr(both, name, getattr(RequestJournal, name).__get__(both))
    _script(both)
    both.terminal(0, "DONE", n_tokens=3)             # a duplicate terminal
    assert st.duplicate_terminals == 1
    assert JournalState.from_json(json.loads(json.dumps(
        st.to_json()))).to_json() == st.to_json()
    assert WAL_KINDS == jjournal.WAL_KINDS


def test_snapshot_plus_tail_equals_full_history(tmp_path):
    p = str(tmp_path / "wal.jsonl")
    j = RequestJournal(p)
    for g in range(4):
        j.submit(g, [1, 2], 4, None, None)
        j.tokens(g, 0, [g])
    j.terminal(0, "DONE", n_tokens=1)
    j.snapshot()
    snap_off = json.load(open(p + ".snap"))["offset"]
    j.tokens(1, 1, [42])
    j.terminal(2, "CANCELLED")
    j.close()
    with_snap, off1 = load_state(p)
    assert jjournal.load_state(p)[0].to_json() == with_snap.to_json()
    os.remove(p + ".snap")
    full, off2 = load_state(p)
    assert with_snap.to_json() == full.to_json()
    assert off1 == off2 == os.path.getsize(p) > snap_off
    j2 = RequestJournal(p, snapshot_every=2)
    j2.submit(9, [3], 2, None, None)
    j2.submit(10, [3], 2, None, None)
    # every append is durable (the snapshot's offset read syncs too)
    assert j2.snapshots == 1 and j2._sink.fsyncs >= 2
    j2.close()


def test_crash_after_appends_at_every_point(tmp_path):
    for n in range(1, 10):
        p = str(tmp_path / f"wal{n}.jsonl")
        j = RequestJournal(p)
        state = crash_after_appends(j, n)
        with pytest.raises(SimulatedCrash):
            _script(j)
        assert state == {"appends": n, "fired": True}
        assert "post_append" not in j.hooks
        j.close()
        st, _ = load_state(p)
        assert st.to_json() == jjournal.load_state(p)[0].to_json()
        assert st.duplicate_terminals == 0
        assert st.n_submits == st.n_terminals + st.n_live
    with pytest.raises(ValueError):
        crash_after_appends(j, 0)


def test_tear_tail_loses_only_the_final_record(tmp_path):
    p = str(tmp_path / "wal.jsonl")
    with RequestJournal(p) as j:
        j.submit(0, [1], 8, None, None)
        j.tokens(0, 0, [1, 2, 3])
        j.tokens(0, 3, [4])                  # this record will be torn
    size = os.path.getsize(p)
    assert tear_tail(p) == os.path.getsize(p) < size
    st, off = load_state(p)
    assert st.live[0]["tokens"] == [1, 2, 3]
    assert jjournal.load_state(p)[0].to_json() == st.to_json()
    with RequestJournal(p) as j2:
        assert j2.state.live[0]["tokens"] == [1, 2, 3]
