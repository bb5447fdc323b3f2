"""The port's observability against the JAX package's on the CPU: the
trainer CLI's ``--remat auto [--mem-budget-mb N]`` plan against the JAX
trainer's (``remat_plan.json``, exactly), its ``--events`` / ``--trace`` /
``--metrics-every`` stream read by both packages' ``validate_events`` and
by ``tools/tracelens.py``, the event-kind registry over the port's source,
and ``MemStat``'s record on the CPU (no allocator counters: -1)."""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.obs import schema as jschema
from repro_torch.events import EventSink, read_events
from repro_torch.obs import (EVENT_KINDS, SPAN_NAMES, MemStat,
                             MetricsRegistry, Tracer, maybe_span, schema)
from repro_torch.plan import RematPlan

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--smoke", "--steps", "2", "--batch", "2", "--seq", "32",
        "--fresh", "--remat", "auto", "--trace", "--metrics-every", "1",
        "--log-every", "1"]
BUDGETS = {"budget": ["--mem-budget-mb", "1"], "sqrt_l": []}


def _run(module, args, tmp, name):
    ck, ev = tmp / f"{name}_ck", tmp / f"{name}.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", module, *ARGS, *args, "--ckpt-dir", str(ck),
         "--events", str(ev)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout, ck / "remat_plan.json", ev


@pytest.fixture(scope="module", params=sorted(BUDGETS))
def runs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    extra = BUDGETS[request.param]
    port = _run("repro_torch.launch.train", ["--device", "cpu", *extra], tmp,
                "port")
    ref = _run("repro.launch.train", ["--attn-backend", "interpret", *extra],
               tmp, "jax")
    return request.param, port, ref


def test_remat_plan_equals_the_jax_trainers(runs):
    name, (out, plan_path, _), (jout, jplan_path, _) = runs
    got, want = json.loads(plan_path.read_text()), \
        json.loads(jplan_path.read_text())
    assert got == want
    plan = RematPlan.load(str(plan_path))
    assert plan.n_layers == 2
    assert plan.source.startswith("budget:" if name == "budget"
                                  else "min_peak:k=1")
    banner = [ln for ln in out.splitlines() if ln.startswith("remat plan")]
    jbanner = [ln for ln in jout.splitlines()
               if ln.startswith("remat plan")]
    assert banner == jbanner


def test_events_validate_in_both_packages_and_render(runs):
    _, (_, _, ev), _ = runs
    assert schema.validate_events(str(ev)) == set()
    assert jschema.validate_events(str(ev)) == set()
    spans = [e for e in read_events(str(ev), "span_begin")]
    assert [e["step"] for e in spans if e["name"] == "train_step"] == [0, 1]
    assert {e["name"] for e in spans} <= set(SPAN_NAMES)
    assert {"data", "train_step", "checkpoint"} <= {e["name"] for e in spans}
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "tracelens.py"),
                          str(ev), "--table"], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "train_step" in out.stdout


def test_mem_samples_carry_the_plan(runs):
    _, (out, plan_path, ev), _ = runs
    samples = read_events(str(ev), "mem_sample")
    assert [s["step"] for s in samples] == [1, 2]
    for s in samples:
        assert s["plan_bytes"] > 0
        assert s["live_bytes"] == -1          # the CPU: no allocator counters
        assert s["frac_of_plan"] is None
    snaps = read_events(str(ev), "metrics_snapshot")
    assert [s["step"] for s in snaps] == [1, 2]
    assert "mem: live peak" in out


def test_no_undeclared_event_kinds_in_the_port():
    assert schema.undeclared_kinds_in_source(
        str(ROOT / "src" / "repro_torch")) == {}
    # the scan does see emit call sites: a private kind is reported
    assert "bogus" in schema.undeclared_kinds_in_source(
        str(pathlib.Path(__file__).parent / "data_obs_kinds"))


def test_schema_is_the_jax_packages():
    assert EVENT_KINDS == jschema.EVENT_KINDS
    assert SPAN_NAMES == jschema.SPAN_NAMES


def test_tracer_spans_and_refusals(tmp_path):
    path = tmp_path / "ev.jsonl"
    with EventSink(str(path)) as sink:
        tr = Tracer(sink, pid="train")
        with maybe_span(tr, "train_step", step=3):
            pass
        with maybe_span(None, "train_step"):
            pass
        with pytest.raises(ValueError, match="undeclared span name"):
            tr.begin("bogus")
    begins = read_events(str(path), "span_begin")
    ends = read_events(str(path), "span_end")
    assert len(begins) == len(ends) == 1
    assert begins[0]["sid"] == ends[0]["sid"] and begins[0]["step"] == 3


def test_memstat_on_the_cpu(tmp_path):
    reg = MetricsRegistry()
    path = tmp_path / "ev.jsonl"
    with EventSink(str(path)) as sink:
        ms = MemStat(sink=sink, registry=reg, plan_bytes=1000,
                     device="cpu")
        rec = ms.sample(5)
    assert rec == {"step": 5, "live_bytes": -1, "n_arrays": -1,
                   "plan_bytes": 1000, "frac_of_plan": None}
    assert read_events(str(path), "mem_sample")[0]["step"] == 5
    assert "over 1 samples" in ms.banner()
    assert MemStat().sample(0)["live_bytes"] == -1
