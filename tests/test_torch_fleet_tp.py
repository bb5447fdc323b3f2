"""The serving fleet on a (data, model) mesh (``launch/serve.py --engine
--replicas N`` under torchrun's environment), against the same fleet on
one rank; the journal's mirror, the router's decision digest and
``MemStat(replica=)``.

The CLI runs through this file (``python test_torch_fleet_tp.py cli OUT
[--crash N] [--plant] ARGV``) under ``tests/tp_ranks.py``'s ``launch``:
each rank writes what its router finished (``{gid: tokens}``) and its
decision digest to ``OUT.<rank>``.  ``--crash N`` arms
``faults.crash_after_appends`` on the journal every rank opens (the
writer on rank 0, its mirror elsewhere: both count the same appends), so
every rank's router dies at the same append, as a whole fleet killed
there; ``--plant`` makes rank 1's router rank its replicas in reverse,
a decision the other ranks do not make.  Smoke llama3-8b, ``--policy
full`` (a bf16 partial sum may flip a near-tie), 16 requests, 2
replicas, ``--chaos-seed 0`` (a replica crash, a sick and a slow
replica), the journal:

  * 2 ranks on (1, 2): rank 0's streams equal a 1-rank run's, token for
    token, rank 1's equal rank 0's, rank 1 prints nothing; every request
    done;
  * the same killed at journal append 100, then ``--recover``: the
    requests live at the crash are rebuilt from rank 0's journal on
    every rank and finish as the 1-rank run's do;
  * a planted decision difference makes every rank exit non-zero, naming
    it;
  * ``--workers`` on 2 ranks: rank 0 spawns the unsharded workers and
    serves the 1-rank streams; rank 1 builds nothing and prints nothing.
"""
from __future__ import annotations

import functools
import json
import pickle
import sys

import numpy as np
import pytest
import torch

import tp_ranks

THIS = tp_ranks.pathlib.Path(__file__).resolve()
FLEET = ["--device", "cpu", "--smoke", "--engine", "--replicas", "2",
         "--policy", "full", "--chaos-seed", "0"]
CRASH_AT = 100


# --------------------------------------------------------------------------
# The CLI child (``python test_torch_fleet_tp.py cli ...``).
# --------------------------------------------------------------------------
def cli_child(out_path, argv) -> int:
    """``launch.serve.main(argv)`` with each rank's finished streams and
    decision digest written to ``out_path.<rank>`` (also when the fleet
    dies at an armed crash)."""
    import os
    from repro_torch.launch import serve
    from repro_torch.serve import Router, SimulatedCrash
    from repro_torch.serve import faults
    rank = os.environ.get("RANK", "0")
    crash = plant = None
    if argv[0] == "--crash":
        crash, argv = int(argv[1]), argv[2:]
    if argv[0] == "--plant":
        plant, argv = True, argv[1:]
    real_run, real_init, seen = Router.run, Router.__init__, {}

    def run(self, trace, **kw):
        seen["router"] = self
        return real_run(self, trace, **kw)

    def init(self, *args, **kw):        # the 1-rank run's digest too
        real_init(self, *args, **{**kw, "digest_decisions": True})
    Router.run, Router.__init__ = run, init
    if crash is not None:
        real_open = serve._open_journal

        def open_journal(path, mesh=None):
            journal = real_open(path, mesh)
            faults.crash_after_appends(journal, crash)
            return journal
        serve._open_journal = open_journal
    if plant and rank == "1":
        real_rank = Router._rank
        Router._rank = lambda self, c: real_rank(self, c)[::-1]
    try:
        rc = serve.main(argv)
    except SimulatedCrash:
        rc = 0
    router = seen.get("router")
    if router is not None:
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump({"streams": {g: list(fr.tokens)
                                     for g, fr in router._reqs.items()
                                     if fr.state == "DONE"},
                         "digest": router.decision_digest(),
                         "decisions": router.n_decisions}, f)
    return rc


def _cli(world, out, *args):
    return tp_ranks.launch(world, [sys.executable, str(THIS), "cli",
                                   str(out), *args])


def _read(out, rank):
    with open(f"{out}.{rank}", "rb") as f:
        return pickle.load(f)


def _ok(outs):
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return outs


# --------------------------------------------------------------------------
# The CLI on (1, 2) against one rank.
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _runs(kind):
    """Both sides of one scenario, all their processes at once: {world:
    (the ranks' outputs, the out path)}."""
    tmp = tp_ranks.tmpdir(f"fleet_tp_{kind}_")
    jobs = {}
    for world in (1, 2):
        out = tmp / f"w{world}"
        wal = ["--journal", str(tmp / f"wal{world}.jsonl")]
        pre = {"journal": [], "crash": ["--crash", str(CRASH_AT)],
               "workers": []}[kind]
        args = FLEET + wal if kind != "workers" else \
            ["--device", "cpu", "--smoke", "--engine", "--replicas", "2",
             "--policy", "full", "--workers", "--requests", "4"]
        jobs[world] = (out, args, pre)
    outs = {w: _ok(_cli(w, out, *pre, *args))
            for w, (out, args, pre) in jobs.items()}
    if kind == "crash":     # then recover from each side's journal
        outs = {w: _ok(_cli(w, f"{out}.rec", *args, "--recover"))
                for w, (out, args, pre) in jobs.items()}
        return {w: (outs[w], f"{jobs[w][0]}.rec") for w in jobs}
    return {w: (outs[w], jobs[w][0]) for w in jobs}


def test_fleet_on_two_ranks_serves_the_one_rank_streams():
    runs = _runs("journal")
    (two, out2), (one, out1) = runs[2], runs[1]
    assert "mesh: data=1 x model=2 (2 devices)" in two[0][1]
    assert "every replica on the mesh data=1 x model=2, kv cache " \
        "sharded over 'heads'" in two[0][1]
    assert "outcomes: done 16 dropped 0" in two[0][1]
    assert "equal on every rank" in two[0][1]
    assert two[1][1] == ""                       # rank 1 prints nothing
    want = _read(out1, 0)
    r0, r1 = _read(out2, 0), _read(out2, 1)
    assert len(want["streams"]) == 16
    assert r0["streams"] == want["streams"]
    assert r1["streams"] == r0["streams"]
    assert r0["digest"] == r1["digest"] == want["digest"]


def test_fleet_recovers_on_two_ranks_as_on_one():
    runs = _runs("crash")
    (two, out2), (one, out1) = runs[2], runs[1]
    assert "recover: " in two[0][1]
    n = int(two[0][1].split("recover: ")[1].split()[0])
    assert n > 0                              # requests were live at the crash
    assert f"recover: {n} requests" in one[0][1]
    assert two[1][1] == ""
    want = _read(out1, 0)
    r0, r1 = _read(out2, 0), _read(out2, 1)
    assert r0["streams"] == want["streams"] == r1["streams"]
    assert r0["digest"] == r1["digest"] == want["digest"]


def test_a_planted_decision_difference_raises(tmp_path):
    outs = _cli(2, tmp_path / "p", "--plant", *FLEET)
    assert all(rc != 0 for rc, _, _ in outs)
    assert "decided differently" in outs[0][2]


def test_workers_stay_unsharded_on_rank_zero():
    runs = _runs("workers")
    (two, out2), (one, out1) = runs[2], runs[1]
    assert "subprocess workers, unsharded, spawned by rank 0" in two[0][1]
    assert two[1][1] == ""
    assert _read(out2, 0)["streams"] == _read(out1, 0)["streams"]
    assert not tp_ranks.pathlib.Path(f"{out2}.1").exists()


# --------------------------------------------------------------------------
# Pieces that need no ranks.
# --------------------------------------------------------------------------
def test_journal_mirror_reduces_the_writers_appends(tmp_path):
    """A mirror built from the writer's state on open, fed the same
    appends, holds the writer's state, counts its appends and snapshots,
    fires its ``post_append`` hook alike, and writes nothing."""
    from repro_torch.serve import RequestJournal, JournalState
    path = tmp_path / "wal.jsonl"
    w = RequestJournal(str(path), snapshot_every=3)
    w.submit(0, [1, 2, 3], 4, None, None)
    w.close()
    writer = RequestJournal(str(path), snapshot_every=3)
    mirror = RequestJournal.mirror(
        JournalState.from_json(json.loads(json.dumps(
            writer.state.to_json()))), snapshot_every=3)
    hooks = {id(j): [] for j in (writer, mirror)}
    for j in (writer, mirror):
        j.hooks["post_append"] = lambda jj, kind, rec: hooks[id(jj)].append(
            kind)
        j.place(0, 1, 0, front=False, emitted=0)
        j.tokens(0, 0, [7, 8])
        j.submit(1, [4, 5], 2, 0, 8)
        j.terminal(0, "DONE", n_tokens=2)
    writer.close()
    mirror.close()
    assert mirror.state.to_json() == writer.state.to_json()
    assert mirror.appends == writer.appends == 4
    assert mirror.snapshots == writer.snapshots == 1
    assert hooks[id(mirror)] == hooks[id(writer)]
    assert mirror.path is None
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "wal.jsonl", "wal.jsonl.snap"]


@functools.lru_cache(maxsize=None)
def _smoke_engines():
    from repro_torch import configs
    from repro_torch.models import transformer
    cfg = configs.smoke_config("llama3-8b")
    model = transformer.init_params(cfg, 0, device="cpu")
    return cfg, model


def _fleet_digest(policy):
    from repro_torch.serve import Router, ServeEngine, synthetic_trace
    cfg, model = _smoke_engines()
    engines = [ServeEngine(model, cfg, max_slots=2, max_len=64,
                           policy_name="full", sampler_keys="request")
               for _ in range(2)]
    router = Router(engines, policy=policy, digest_decisions=True)
    router.run(synthetic_trace(6, seed=0, vocab=cfg.vocab, mean_prompt=8,
                               max_prompt=16, mean_gen=4, max_gen=8))
    return router.n_decisions, router.decision_digest()


def test_decision_digest_follows_the_decisions():
    a, b = _fleet_digest("least_loaded"), _fleet_digest("least_loaded")
    assert a == b and a[0] > 0
    assert _fleet_digest("round_robin")[1] != a[1]
    from repro_torch.serve import Router, ServeEngine
    cfg, model = _smoke_engines()
    plain = Router([ServeEngine(model, cfg, max_slots=2, max_len=64,
                                policy_name="full")])
    assert plain.decision_digest() is None     # hashed only when asked


class _Reduced(Exception):
    pass


def test_decision_check_reduces_on_the_replicas_device(monkeypatch):
    """``_check_decisions`` hands the collective a tensor on the
    replicas' device, as NCCL (the card's backend, which takes no host
    tensors) needs: a stub backend that accepts only that device."""
    import types
    from repro_torch.launch import serve
    dev = torch.device("meta")
    seen = []

    def all_reduce(t, op=None, group=None):
        seen.append(t.device)
        if t.device != dev:
            raise RuntimeError("no host tensors on this backend")
        raise _Reduced

    monkeypatch.setattr(serve.dist, "all_reduce", all_reduce)
    router = types.SimpleNamespace(
        n_decisions=3, decision_digest=lambda: "ab" * 32,
        engines=[types.SimpleNamespace(device=dev)])
    with pytest.raises(_Reduced):
        serve._check_decisions(router, object(), "by router step 0")
    assert seen == [dev]


def test_memstat_replica_on_the_reference_record_keys():
    """``MemStat(replica=)`` puts ``replica`` on the record, whose keys
    are the reference's (on the CPU, where neither package has allocator
    counters)."""
    from repro.obs.memstat import MemStat as JMemStat
    from repro_torch.obs import MemStat
    got = MemStat(plan_bytes=2**20, replica=3).sample(5)
    want = JMemStat(plan_bytes=2**20, replica=3).sample(5)
    assert set(got) == set(want) - {"device_peak_bytes"}
    assert got["replica"] == want["replica"] == 3
    assert "replica" not in MemStat().sample(0)
    assert np.isclose(got["plan_bytes"], want["plan_bytes"])


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        raise SystemExit(cli_child(sys.argv[2], sys.argv[3:]))
