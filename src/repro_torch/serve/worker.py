"""Process-isolated ServeEngine replicas behind a pipe RPC (a port of
``repro.serve.worker``).

In-process fleet replicas share the router's process, so a "crash" is a
simulation (``Router.kill`` closing a ledger) and the breaker only ever
sees in-process state.  This module puts a replica in a REAL subprocess:

* the child (started with ``python -c "from repro_torch.serve.worker
  import main; ..."``, fork + exec, so it never inherits the parent's
  CUDA context) builds its own engine from an importable factory spec
  (a worker makes its own weights on its own device, the same way a real
  deployment replica would), warms it, and serves a small
  length-prefixed pickle RPC over stdin/stdout — submit / step / harvest
  / evict / cancel / drain / summary / poison / kernel_launches / ping;
* the parent-side :class:`WorkerProxy` exposes the SAME replica surface
  the router consumes from in-process engines — ``submit`` /
  ``evict_request`` / ``step`` / ``summary`` / ``kernel_launches``, a
  ``scheduler``/``pool``/``metrics`` view, and a ``_requests`` mirror
  refreshed from each step's harvest payload — so ``Router`` fronts a
  mixed fleet of engines and workers without knowing which is which;
* ``terminate()`` is an actual ``SIGKILL``.  After a kill (or any pipe
  EOF / RPC timeout — a missed heartbeat) the proxy marks itself dead:
  submits raise :class:`AdmissionRejected`, steps are no-ops, and the
  token counter freezes, so the router's stall detector sees a replica
  with resident work and no progress and the breaker quarantines it
  ACROSS the process boundary — evacuation then replays the victims
  from the router's journal/mirror on the survivors;
* every successful RPC reply doubles as a heartbeat
  (``heartbeat_age()``); the dead proxy's ledger is synthesized from
  the ``_requests`` mirror (evictions counted as ``MIGRATED``), and its
  pool reports zero leaks — the OS reclaimed the process, there is no
  slot left to leak.

Protocol frames are ``4-byte big-endian length + pickle`` over the
child's stdin/stdout; the child re-points ``sys.stdout`` at stderr
before anything else runs so library prints can never corrupt the
stream.  Pickle is fine here: both ends are the same trusted codebase
on one machine (prompts are numpy arrays — JSON would copy them
through lists on the hot path).  Frames carry numpy arrays and Python
scalars only, never a torch tensor (a CUDA tensor would cross the host
or fail in the other process).

Where the JAX worker's handshake carries its jit cache sizes, this one
carries the child's kernel launch counters after warmup
(``repro_torch.serve.kernel_launches``), and ``kernel_launches()`` reads
them later, so the parent can show that a child's engine ran the
kernels.
"""
from __future__ import annotations

import importlib
import os
import pickle
import select
import signal
import struct
import subprocess
import sys
import time
from typing import Optional

import numpy as np

from repro_torch.serve.engine import kernel_launches
from repro_torch.serve.faults import poison_slot
from repro_torch.serve.scheduler import (DECODE, MIGRATED, PREFILL, QUEUED,
                                         TERMINAL, AdmissionRejected)

_LEN = struct.Struct(">I")

#: the default engine factory, as the child imports it
FACTORY = "repro_torch.serve.worker:engine_factory"

#: exception types the RPC re-raises by name on the parent side
_RAISABLE = {"AdmissionRejected": AdmissionRejected,
             "ValueError": ValueError,
             "NotImplementedError": NotImplementedError}


class WorkerDied(RuntimeError):
    """The worker subprocess is gone (SIGKILL, EOF, or RPC timeout)."""


def engine_factory(arch: str = "llama3-8b", smoke: bool = True,
                   init_seed: int = 0, device: str = "cuda",
                   **engine_kwargs):
    """Default worker factory: build config + weights + engine from
    scratch inside the child (a replica owns its own weights), on the
    card unless ``device="cpu"``, in the policy's compute dtype."""
    from repro_torch import configs
    from repro_torch.core.device import resolve_device
    from repro_torch.core.mixed_precision import get_policy
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    cfg = configs.smoke_config(arch) if smoke else configs.get_config(arch)
    policy = get_policy(engine_kwargs.get("policy_name", "bf16"))
    model = transformer.init_params(cfg, init_seed,
                                    device=resolve_device(device),
                                    dtype=policy.compute_dtype)
    return ServeEngine(model, cfg, **engine_kwargs)


# -- framing ----------------------------------------------------------------
def _write_frame(stream, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(_LEN.pack(len(payload)) + payload)
    stream.flush()


def _read_exact_blocking(stream, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            raise EOFError("pipe closed")
        buf += chunk
    return buf


def _read_frame_blocking(stream):
    (n,) = _LEN.unpack(_read_exact_blocking(stream, _LEN.size))
    return pickle.loads(_read_exact_blocking(stream, n))


# -- child side -------------------------------------------------------------
def _snapshot(engine) -> dict:
    """The harvest payload: everything the proxy mirrors per step."""
    m, s, p = engine.metrics, engine.scheduler, engine.pool
    return {
        "step_no": engine.step_no,
        "requests": engine.request_states(),
        "metrics": {"faults": m.faults, "tokens_emitted": m.tokens_emitted,
                    "rejected": m.rejected, "retries": m.retries},
        # full obs registry (counters + streaming histograms): the proxy
        # keeps the latest copy so fleet metrics survive a SIGKILL
        "registry": m.registry_snapshot(),
        "sched": {"queue_depth": s.queue_depth, "resident": s.resident},
        "pool": {"free_slots": p.free_slots, "occupancy": p.occupancy,
                 "allocs": p.allocs, "frees": p.frees,
                 "quarantines": p.quarantines,
                 "quarantined": p.quarantined},
    }


def _dispatch(engine, op: str, msg: dict):
    if op == "submit":
        rid = engine.submit(msg["prompt"], msg["max_new_tokens"],
                            eos_id=msg.get("eos_id"),
                            deadline_steps=msg.get("deadline_steps"),
                            front=msg.get("front", False),
                            key_id=msg.get("key_id"),
                            emitted=msg.get("emitted"))
        return {"rid": rid, "snap": _snapshot(engine)}
    if op == "step":
        if engine.scheduler.has_work():
            engine.step()
        return _snapshot(engine)
    if op == "harvest":
        return _snapshot(engine)
    if op == "evict":
        req = engine.evict_request(msg["rid"], msg["state"])
        out = None if req is None else {"state": req.state,
                                        "tokens": list(req.tokens)}
        return {"req": out, "snap": _snapshot(engine)}
    if op == "cancel":
        ok = engine.cancel(msg["rid"])
        return {"ok": ok, "snap": _snapshot(engine)}
    if op == "drain":
        summary = engine.drain(
            cancel_queued=msg.get("cancel_queued", True),
            max_steps=msg.get("max_steps"))
        return {"summary": summary, "snap": _snapshot(engine)}
    if op == "summary":
        return engine.summary(stalled=msg.get("stalled", False))
    if op == "kernel_launches":
        return kernel_launches()
    if op == "reset":
        engine.reset()
        return _snapshot(engine)
    if op == "poison":
        poison_slot(engine, msg["slot"], msg["value"])
        return True
    if op == "ping":
        return {"t": time.time(), "step_no": engine.step_no}
    raise ValueError(f"worker: unknown op {op!r}")


def _serve(engine, inp, out) -> None:
    while True:
        try:
            msg = _read_frame_blocking(inp)
        except EOFError:
            return                         # parent went away: exit quietly
        op = msg.get("op")
        if op == "shutdown":
            _write_frame(out, {"ok": True, "result": None})
            return
        try:
            result = _dispatch(engine, op, msg)
            _write_frame(out, {"ok": True, "result": result})
        except Exception as e:             # errors cross the pipe by name
            _write_frame(out, {"ok": False, "error": type(e).__name__,
                               "msg": str(e)})


def main() -> int:
    out = sys.stdout.buffer
    sys.stdout = sys.stderr    # protocol owns the real stdout; prints -> err
    inp = sys.stdin.buffer
    hello = _read_frame_blocking(inp)
    try:
        mod, _, fn = hello["factory"].partition(":")
        factory = getattr(importlib.import_module(mod), fn)
        engine = factory(**hello.get("kwargs", {}))
        counts = engine.warmup() if hello.get("warmup", True) \
            else kernel_launches()
        _write_frame(out, {"ok": True, "result": {
            "pid": os.getpid(),
            "temperature": engine.temperature,
            "sampler_keys": engine.sampler_keys,
            "max_len": engine.max_len,
            "buckets": tuple(engine.buckets),
            "max_slots": engine.pool.max_slots,
            "max_queue": engine.scheduler.max_queue,
            "kernel_launches": counts,
        }})
    except Exception as e:
        _write_frame(out, {"ok": False, "error": type(e).__name__,
                           "msg": str(e)})
        return 1
    _serve(engine, inp, out)
    return 0


# -- parent side ------------------------------------------------------------
class _SchedView:
    """Mirror of the worker scheduler's router-facing numbers."""

    def __init__(self, max_queue: Optional[int]):
        self.queue_depth = 0
        self.resident = 0
        self.max_queue = max_queue

    def has_work(self) -> bool:
        return self.queue_depth > 0 or self.resident > 0


class _PoolView:
    """Mirror of the worker pool's counters.  ``close_dead()`` zeroes
    the residency: the process is gone, so by definition no slot of its
    pool is still held (the OS reclaimed it) — the fleet-level leak
    check then only measures the survivors."""

    def __init__(self, max_slots: int):
        self.max_slots = max_slots
        self.free_slots = max_slots
        self.occupancy = 0
        self.allocs = 0
        self.frees = 0
        self.quarantines = 0
        self.quarantined = 0

    def update(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)

    def close_dead(self) -> None:
        self.frees = self.allocs
        self.occupancy = 0
        self.quarantined = 0
        self.free_slots = self.max_slots

    def audit(self) -> bool:
        return True


class _MetricsView:
    """Mirror of the worker metrics the router's breaker reads.  The
    counters freeze at death — which is exactly what the stall detector
    needs to see."""

    def __init__(self):
        self.replica: Optional[int] = None
        self.faults = 0
        self.tokens_emitted = 0
        self.rejected = 0
        self.retries = 0
        # last absorbed registry snapshot; persists after death so the
        # dead replica's histograms still merge into the fleet view
        self._registry_snap: Optional[dict] = None

    def registry_snapshot(self) -> dict:
        if self._registry_snap is None:
            return {"counters": {}, "gauges": {}, "hists": {}}
        return self._registry_snap


class _ReqView:
    """Mirror of one worker-side request (state + healthy tokens)."""

    __slots__ = ("rid", "state", "tokens", "slot")

    def __init__(self, rid: int, state: str, tokens, slot=None):
        self.rid = rid
        self.state = state
        self.tokens = list(tokens)
        self.slot = slot


class WorkerProxy:
    """Router-facing handle to one subprocess replica.

    Construct N proxies back to back, then ``wait_ready()`` each — the
    children build and warm their engines concurrently.  Or use
    :func:`spawn_worker` for the one-shot path.
    """

    def __init__(self, factory: str = FACTORY,
                 kwargs: Optional[dict] = None, *, warmup: bool = True,
                 rpc_timeout_s: float = 120.0,
                 spawn_timeout_s: float = 600.0):
        self.rpc_timeout_s = rpc_timeout_s
        self.spawn_timeout_s = spawn_timeout_s
        self.alive = False
        self.death_reason: Optional[str] = None
        self.pid: Optional[int] = None
        self._ready = False
        self._requests: dict[int, _ReqView] = {}
        self._dead_evictions = 0
        self._m_steps = 0
        self._launches: Optional[dict] = None
        self._last_beat = time.monotonic()
        self.metrics = _MetricsView()
        self.scheduler = _SchedView(max_queue=None)
        #: optional repro_torch.obs Tracer: each RPC round-trip becomes an
        #: ``rpc`` span, so cross-process overhead shows on the timeline
        self.tracer = None

        env = dict(os.environ)
        src = os.path.dirname(os.path.dirname(
            os.path.abspath(__import__("repro_torch").__file__)))
        env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                                   if env.get("PYTHONPATH") else "")
        # -c (not -m): the package __init__ imports this module, and
        # runpy would warn about executing an already-imported module.
        # Popen is fork + exec: the child starts with no CUDA context
        self._proc = subprocess.Popen(
            [sys.executable, "-c",
             "from repro_torch.serve.worker import main; "
             "raise SystemExit(main())"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        _write_frame(self._proc.stdin,
                     {"factory": factory, "kwargs": kwargs or {},
                      "warmup": warmup})

    # -- lifecycle ---------------------------------------------------------
    def wait_ready(self) -> "WorkerProxy":
        """Block until the child finished building + warming its engine
        (the hello reply), then adopt its static attributes."""
        if self._ready:
            return self
        reply = self._read_frame(self.spawn_timeout_s)
        if not reply.get("ok"):
            self._mark_dead(f"spawn failed: {reply.get('msg')}")
            raise WorkerDied(f"worker failed to start: {reply.get('msg')}")
        h = reply["result"]
        self.pid = h["pid"]
        self.temperature = h["temperature"]
        self.sampler_keys = h["sampler_keys"]
        self.max_len = h["max_len"]
        self.buckets = tuple(h["buckets"])
        self.scheduler.max_queue = h["max_queue"]
        self.pool = _PoolView(h["max_slots"])
        self._launches = dict(h["kernel_launches"])
        self.alive = True
        self._ready = True
        self._last_beat = time.monotonic()
        return self

    def heartbeat_age(self) -> float:
        """Seconds since the worker last answered an RPC — the stall
        signal the breaker reads across the process boundary."""
        return time.monotonic() - self._last_beat

    def terminate(self) -> bool:
        """SIGKILL the worker — ``Router.kill`` on a subprocess replica
        is a real kill, not a simulation.  Returns False if already
        dead."""
        if not self.alive:
            return False
        self._mark_dead("SIGKILL")
        return True

    def shutdown(self) -> None:
        """Graceful exit: ask the child to stop, then reap it."""
        if self.alive:
            try:
                _write_frame(self._proc.stdin, {"op": "shutdown"})
                self._read_frame(self.rpc_timeout_s)
            except (OSError, EOFError, TimeoutError):
                pass
            self.alive = False
            self.death_reason = "shutdown"
        self._reap()

    def _reap(self) -> None:
        if self._proc.poll() is None:
            try:
                self._proc.kill()
            except OSError:
                pass
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass

    def _mark_dead(self, reason: str) -> None:
        if self.alive or self.death_reason is None:
            self.death_reason = reason
        self.alive = False
        if self._proc.poll() is None:
            try:
                os.kill(self._proc.pid, signal.SIGKILL)
            except OSError:
                pass
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass

    # -- framing with timeout ----------------------------------------------
    def _read_frame(self, timeout: float):
        def read_exact(n: int) -> bytes:
            buf = b""
            deadline = time.monotonic() + timeout
            fd = self._proc.stdout
            while len(buf) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"worker RPC timed out ({timeout}s)")
                r, _, _ = select.select([fd], [], [], left)
                if not r:
                    continue
                chunk = os.read(fd.fileno(), n - len(buf))
                if not chunk:
                    raise EOFError("worker pipe closed")
                buf += chunk
            return buf

        (n,) = _LEN.unpack(read_exact(_LEN.size))
        return pickle.loads(read_exact(n))

    def _rpc(self, op: str, **kw):
        """One request/reply round.  Any transport failure (EOF after a
        SIGKILL, a hung child) marks the proxy dead and returns None —
        the router then sees frozen counters, not an exception."""
        if not self.alive:
            return None
        sid = None if self.tracer is None else \
            self.tracer.begin("rpc", op=op)
        try:
            _write_frame(self._proc.stdin, {"op": op, **kw})
            reply = self._read_frame(self.rpc_timeout_s)
        except (OSError, EOFError, TimeoutError) as e:
            self._mark_dead(f"{type(e).__name__} during {op!r}")
            if self.tracer is not None:
                self.tracer.end(sid, ok=False, error=type(e).__name__)
            return None
        if self.tracer is not None:
            self.tracer.end(sid, ok=bool(reply.get("ok")))
        self._last_beat = time.monotonic()
        if not reply.get("ok"):
            exc = _RAISABLE.get(reply.get("error"), RuntimeError)
            raise exc(reply.get("msg"))
        return reply["result"]

    # -- mirrors -----------------------------------------------------------
    def _absorb(self, snap: Optional[dict]) -> None:
        if snap is None:
            return
        for rid, d in snap["requests"].items():
            self._requests[rid] = _ReqView(rid, d["state"], d["tokens"],
                                           d["slot"])
        m = snap["metrics"]
        self.metrics.faults = m["faults"]
        self.metrics.tokens_emitted = m["tokens_emitted"]
        self.metrics.rejected = m["rejected"]
        self.metrics.retries = m["retries"]
        if snap.get("registry") is not None:
            self.metrics._registry_snap = snap["registry"]
        self.scheduler.queue_depth = snap["sched"]["queue_depth"]
        self.scheduler.resident = snap["sched"]["resident"]
        self.pool.update(snap["pool"])

    def _mirror_summary(self) -> dict:
        """Ledger synthesized from the mirror once the worker is dead —
        the 'close the dead ledger' path ``Router.reconcile`` sums."""
        reqs = list(self._requests.values())
        by = {s: sum(1 for r in reqs if r.state == s)
              for s in ("DONE", "CANCELLED", "DROPPED", "FAILED",
                        "MIGRATED")}
        done_tokens = sum(len(r.tokens) for r in reqs if r.state == "DONE")
        return {
            "n_requests": len(reqs), "n_done": by["DONE"],
            "n_cancelled": by["CANCELLED"], "n_dropped": by["DROPPED"],
            "n_failed": by["FAILED"], "n_migrated_out": by["MIGRATED"],
            "n_rejected": self.metrics.rejected,
            "n_faults": self.metrics.faults,
            "n_retried": self.metrics.retries,
            "retry_success_rate": 1.0,
            "total_tokens": sum(len(r.tokens) for r in reqs),
            "goodput_tokens": done_tokens,
            "wall_s": 0.0, "tokens_per_s": 0.0,
            "goodput_tokens_per_s": 0.0, "n_steps": self._m_steps,
            "dead": True, "death_reason": self.death_reason,
        }

    # -- the replica surface the Router consumes ---------------------------
    def submit(self, prompt, max_new_tokens: int, eos_id=None,
               arrival_step=None, deadline_steps=None, front: bool = False,
               key_id=None, emitted=None) -> int:
        if not self.alive:
            raise AdmissionRejected(
                f"worker {self.pid} is dead ({self.death_reason})")
        res = self._rpc("submit", prompt=np.asarray(prompt, np.int32),
                        max_new_tokens=max_new_tokens, eos_id=eos_id,
                        deadline_steps=deadline_steps, front=front,
                        key_id=key_id,
                        emitted=None if emitted is None else
                        [int(t) for t in emitted])
        if res is None:                    # died mid-submit
            raise AdmissionRejected(
                f"worker {self.pid} died during submit")
        self._absorb(res["snap"])
        rid = res["rid"]
        if rid not in self._requests:      # snapshot races are impossible
            self._requests[rid] = _ReqView(rid, QUEUED,
                                           emitted or [], None)
        return rid

    def step(self) -> None:
        snap = self._rpc("step")
        if snap is not None:
            self._m_steps += 1
            self._absorb(snap)

    def evict_request(self, rid: int, state: str = MIGRATED):
        mirror = self._requests.get(rid)
        if not self.alive:
            # dead path: close the ledger from the mirror — a real
            # deployment cannot read a dead process's memory, so the
            # healthy-token source of truth is the caller's journal;
            # the mirror is the same stream (it only ever held
            # harvested healthy tokens)
            if mirror is None or mirror.state in TERMINAL:
                return None
            was_resident = mirror.state in (PREFILL, DECODE)
            mirror.state = state
            self._dead_evictions += 1
            if was_resident:
                self.scheduler.resident = max(
                    0, self.scheduler.resident - 1)
            else:
                self.scheduler.queue_depth = max(
                    0, self.scheduler.queue_depth - 1)
            if self.scheduler.resident == 0:
                self.pool.close_dead()
            return mirror
        res = self._rpc("evict", rid=rid, state=state)
        if res is None:
            return self.evict_request(rid, state)   # died: dead path
        self._absorb(res["snap"])
        if res["req"] is None:
            return None
        view = self._requests.get(rid)
        if view is None:
            view = self._requests[rid] = _ReqView(rid, res["req"]["state"],
                                                  res["req"]["tokens"])
        view.state = res["req"]["state"]
        view.tokens = list(res["req"]["tokens"])
        return view

    def cancel(self, rid: int) -> bool:
        if not self.alive:
            return self.evict_request(rid, "CANCELLED") is not None
        res = self._rpc("cancel", rid=rid)
        if res is None:
            return False
        self._absorb(res["snap"])
        return res["ok"]

    def drain(self, *, cancel_queued: bool = True, max_steps=None) -> dict:
        res = self._rpc("drain", cancel_queued=cancel_queued,
                        max_steps=max_steps)
        if res is None:
            return self._mirror_summary()
        self._absorb(res["snap"])
        return res["summary"]

    def harvest(self) -> None:
        """Refresh the mirror without stepping (an explicit heartbeat)."""
        self._absorb(self._rpc("harvest"))

    def request_states(self) -> dict:
        """Same shape as ``ServeEngine.request_states``, served from the
        mirror (refreshed first when the worker is alive) — usable on a
        dead worker, where it is the surviving ledger."""
        if self.alive:
            self.harvest()
        return {rid: {"state": v.state, "tokens": list(v.tokens),
                      "slot": v.slot}
                for rid, v in self._requests.items()}

    def ping(self) -> bool:
        return self._rpc("ping") is not None

    def poison_slot(self, slot: int, value: float) -> bool:
        """Remote cache poison — lets the fault harness trip the
        worker's OWN decode sentinel across the process boundary."""
        return bool(self._rpc("poison", slot=slot, value=value))

    def warmup(self) -> dict:
        """Workers warm at spawn; this is the idempotent re-entry
        ``make_fleet`` calls.  Returns the child's kernel launch counters
        after its warmup."""
        self.wait_ready()
        return dict(self._launches)

    def reset(self) -> None:
        snap = self._rpc("reset")
        if snap is not None:
            self._requests.clear()
            self._dead_evictions = 0
            self._m_steps = 0
            self._absorb(snap)

    def kernel_launches(self) -> dict:
        """The child's kernel launch counters (the last known ones once
        the worker is dead)."""
        res = self._rpc("kernel_launches")
        if res is not None:
            self._launches = dict(res)
        return dict(self._launches or {})

    def summary(self, *, stalled: bool = False) -> dict:
        if not self.alive:
            return self._mirror_summary()
        res = self._rpc("summary", stalled=stalled)
        return self._mirror_summary() if res is None else res


def spawn_worker(factory: str = FACTORY,
                 kwargs: Optional[dict] = None, *, warmup: bool = True,
                 rpc_timeout_s: float = 120.0,
                 spawn_timeout_s: float = 600.0) -> WorkerProxy:
    """Spawn one worker and block until its engine is warm."""
    return WorkerProxy(factory, kwargs, warmup=warmup,
                       rpc_timeout_s=rpc_timeout_s,
                       spawn_timeout_s=spawn_timeout_s).wait_ready()


def spawn_workers(n: int,
                  factory: str = FACTORY,
                  kwargs: Optional[dict] = None, *, warmup: bool = True,
                  rpc_timeout_s: float = 120.0,
                  spawn_timeout_s: float = 600.0) -> list[WorkerProxy]:
    """Spawn N workers CONCURRENTLY (children build + warm in parallel;
    the readiness waits are sequential but overlap the builds)."""
    ws = [WorkerProxy(factory, kwargs, warmup=warmup,
                      rpc_timeout_s=rpc_timeout_s,
                      spawn_timeout_s=spawn_timeout_s) for _ in range(n)]
    return [w.wait_ready() for w in ws]


if __name__ == "__main__":
    raise SystemExit(main())
