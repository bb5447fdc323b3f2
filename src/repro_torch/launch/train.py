"""Training driver on one device (counterpart of ``repro.launch.train``).

Fault-tolerance features wired here:
  * resume from the latest intact atomic checkpoint (params + AdamW state
    + loss scale + data-iterator state, in the JAX package's layout and
    on-disk format, so either package resumes the other's run);
  * SIGTERM/SIGINT -> save-and-exit (preemption handling);
  * periodic + final checkpointing (keep-last GC), with the config
    identity verified on restore;
  * step watchdog: a daemon thread logs when a step exceeds
    ``factor`` x the trailing-median step time (straggler / hang);
  * ``--guard``: NaN/Inf-grad steps apply no update (skipped on the
    device via ``TrainConfig.skip_nonfinite``) and a rolling-median
    loss-spike detector (``train/guards.py``) escalates consecutive bad
    steps to a rollback to the last good checkpoint.

Runs on the CUDA card by default, where attention goes through the
hand-written flash kernels (forward, and delta / dQ / dKV backward);
without a card it exits with an error unless ``--device cpu`` asks for
the plain versions:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --smoke --steps 50 --batch 8 --seq 128 --device cpu

Not ported yet: ``--remat auto`` and ``--mem-budget-mb`` (the remat
planner), ``--trace`` and ``--metrics-every`` (the tracer and memstat), the mesh
flags (``--max-model``) and ``--attn-backend`` (the port dispatches on
the device).
"""
from __future__ import annotations

import argparse
import os
import signal
import statistics
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpointing.ckpt import CheckpointManager
from repro_torch.core.checkpoint import CheckpointConfig
from repro_torch.data.synthetic import token_stream
from repro_torch.events import EventSink
from repro_torch.launch.serve import resolve_device
from repro_torch.models import bridge, transformer
from repro_torch.optim import adamw
from repro_torch.train.guards import GuardConfig, TrainGuard
from repro_torch.train.train_step import (TrainConfig, build_train_step,
                                          init_loss_scale)


class Watchdog:
    """Logs when the current step runs long (straggler / hang detection).

    Every field is read and written under ``_lock``; the alert latch is
    "alerted at step generation N", so an alerted step still records its
    duration at ``step_end``.  With a ``sink`` each alert is also a
    ``watchdog_alert`` event."""

    def __init__(self, factor: float = 5.0, min_history: int = 5,
                 *, sink: EventSink | None = None):
        self.factor, self.min_history = factor, min_history
        self.times: list[float] = []
        self._started: float | None = None
        self._gen = 0                 # step generation (monotonic)
        self._alerted_gen = -1        # last generation already alerted
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.alerts = 0
        self.sink = sink
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def step_start(self):
        with self._lock:
            self._gen += 1
            self._started = time.time()

    def step_end(self):
        with self._lock:
            if self._started is not None:
                self.times.append(time.time() - self._started)
                self.times = self.times[-100:]
            self._started = None

    def _run(self):
        while not self._stop.wait(0.5):
            with self._lock:
                if (self._started is None
                        or self._gen == self._alerted_gen
                        or len(self.times) < self.min_history):
                    continue
                med = statistics.median(self.times)
                running = time.time() - self._started
                if running <= self.factor * med:
                    continue
                self.alerts += 1
                self._alerted_gen = self._gen    # one alert per step
            print(f"[watchdog] step running {running:.1f}s"
                  f" > {self.factor:.0f}x median {med:.2f}s — straggler?")
            if self.sink is not None:
                self.sink.emit("watchdog_alert", running_s=running,
                               median_s=med, factor=self.factor)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)


def synthetic_lm_batches(cfg, batch: int, seq: int, *, seed=0, state=None,
                         device="cpu"):
    """Deterministic, resumable synthetic LM stream (batch index = state):
    the same token batches as the JAX package's for the same seed."""
    start = state or 0
    corpus = token_stream(max(200_000, batch * (seq + 1) * 4), cfg.vocab,
                          seed=seed)
    i = start
    while True:
        rng = np.random.default_rng((seed, i))
        offs = rng.integers(0, len(corpus) - seq - 1, size=batch)
        toks = np.stack([corpus[o:o + seq] for o in offs])
        labs = np.stack([corpus[o + 1:o + seq + 1] for o in offs])
        yield i, {"tokens": torch.from_numpy(toks).to(device),
                  "labels": torch.from_numpy(labs).to(device)}
        i += 1


def init_state(cfg, seed: int, device):
    """Fresh f32 master weights (``requires_grad`` on) and AdamW state."""
    model = transformer.init_params(cfg, seed, device=device,
                                    dtype=torch.float32).requires_grad_()
    return model, adamw.init(dict(model.named_parameters()))


def train_state(model, opt) -> dict:
    """The checkpointed state in the JAX package's layout."""
    return {"params": bridge.export_params(model),
            "opt": bridge.export_opt_state(opt)}


def load_state(cfg, state: dict, device):
    model = bridge.load_jax_params(cfg, state["params"],
                                   device=device).requires_grad_()
    return model, bridge.load_opt_state(state["opt"], device=device)


def run(args) -> int:
    device = resolve_device(args.device)
    cfg = configs.smoke_config(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    remat = CheckpointConfig(enabled=args.remat == "on",
                             policy=args.remat_policy)
    tc = TrainConfig(
        policy=args.policy, remat=remat, accum=args.accum,
        use_loss_scale=(args.policy == "fp16"), skip_nonfinite=args.guard,
        opt=adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=min(100, args.steps // 10 + 1)))
    step_fn = build_train_step(cfg, tc)
    print(f"policy {args.policy}, remat {args.remat} "
          f"({args.remat_policy}), accum {args.accum}, "
          f"batch {args.batch} x seq {args.seq}")

    mgr = CheckpointManager(args.ckpt_dir, keep_last=args.keep_last)
    model, opt = init_state(cfg, args.seed, device)
    ls = init_loss_scale(tc, device)
    start_step, data_state = 0, 0

    latest = mgr.latest_intact_step()
    if latest is not None and not args.fresh:
        restored, extra = mgr.restore(latest, train_state(model, opt),
                                      config=cfg.arch_id)
        model, opt = load_state(cfg, restored, device)
        start_step = extra.get("step", latest)
        data_state = extra.get("data_state", 0)
        if tc.use_loss_scale and "loss_scale" in extra:
            ls.scale.fill_(extra["loss_scale"])
        print(f"resumed from step {start_step} (data batch {data_state})")

    stop = {"now": False}

    def _sig(_s, _f):
        print("[signal] preemption notice — checkpoint and exit")
        stop["now"] = True

    old_handlers = [signal.signal(s, _sig) for s in (signal.SIGTERM,
                                                     signal.SIGINT)]

    def save(step):
        # ``step`` = completed steps; a resume continues there
        mgr.save(step, train_state(model, opt),
                 extra={"step": step, "data_state": data_state,
                        "loss_scale": float(ls.scale), "arch": cfg.arch_id},
                 config=cfg.arch_id)

    sink = EventSink(args.events) if args.events else None
    guard = None
    if args.guard:
        guard = TrainGuard(GuardConfig(
            window=args.guard_window, spike_factor=args.guard_spike_factor,
            rollback_after=args.guard_rollback_after), sink=sink)
        print(f"guard: skip non-finite steps on the device; loss spike > "
              f"{args.guard_spike_factor}x rolling median; "
              f"{args.guard_rollback_after} consecutive bad steps -> "
              f"rollback (costs one loss sync per step)")
    wd = Watchdog(sink=sink)
    data = synthetic_lm_batches(cfg, args.batch, args.seq, seed=args.seed,
                                state=data_state, device=device)
    t0 = time.time()
    step = start_step
    try:
        while step < args.steps:
            data_state, batch = next(data)
            wd.step_start()
            model, opt, ls, metrics = step_fn(model, opt, ls, batch)
            verdict = TrainGuard.OK
            if guard is not None:
                verdict = guard.observe(
                    float(metrics["loss"]),  # sync
                    bool(metrics["grads_finite"]),
                    grad_norm=float(metrics["grad_norm"]))
            if verdict == TrainGuard.ROLLBACK:
                wd.step_end()
                if guard.rollbacks > args.guard_max_rollbacks:
                    print(f"[guard] {guard.rollbacks} rollbacks exceed "
                          f"--guard-max-rollbacks="
                          f"{args.guard_max_rollbacks} — persistent "
                          f"fault, aborting ({guard.counters()})")
                    return 1
                # never roll back onto a torn or corrupt checkpoint
                latest = mgr.latest_intact_step()
                if latest is None:
                    print("[guard] rollback with no checkpoint on disk — "
                          "restarting from init")
                    model, opt = init_state(cfg, args.seed, device)
                    step, data_state = 0, 0
                else:
                    restored, extra = mgr.restore(
                        latest, train_state(model, opt), config=cfg.arch_id)
                    model, opt = load_state(cfg, restored, device)
                    step = extra.get("step", latest)
                    data_state = extra.get("data_state", 0)
                    if tc.use_loss_scale and "loss_scale" in extra:
                        ls.scale.fill_(extra["loss_scale"])
                guard.reset_history()
                data = synthetic_lm_batches(cfg, args.batch, args.seq,
                                            seed=args.seed, state=data_state,
                                            device=device)
                print(f"[guard] rolled back to step {step} "
                      f"(data batch {data_state}; {guard.counters()})")
                continue
            if verdict == TrainGuard.SKIP:
                applied = bool(metrics["grads_finite"])
                print(f"[guard] step {step}: bad step ({guard.counters()}) "
                      f"— update "
                      f"{'applied; loss quarantined' if applied else 'skipped on the device'}")
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])  # sync point
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"({(time.time()-t0):.1f}s)")
            wd.step_end()
            data_state += 1
            step += 1
            healthy = guard is None or guard.bad_streak == 0
            if step % args.ckpt_every == 0 and healthy:
                # never checkpoint mid-bad-streak: the rollback target
                # must be a good state
                save(step)
            if stop["now"]:
                if healthy:
                    save(step)
                return 0
        save(args.steps)
    finally:
        wd.close()
        if sink is not None:
            sink.close()
        for s, h in zip((signal.SIGTERM, signal.SIGINT), old_handlers):
            signal.signal(s, h)
    if guard is not None:
        print(f"guard: {guard.counters()}")
    print("done")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (the plain "
                         "PyTorch versions)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--policy", default="bf16",
                    choices=["full", "bf16", "fp16", "bf16_params",
                             "resid_bf16"],
                    help="mixed-precision policy; resid_bf16 = f32 compute "
                         "with the flash op's saved (q,k,v,o) residuals "
                         "stored in bf16 (stats stay f32)")
    ap.add_argument("--remat", default="on", choices=["on", "off"],
                    help="sequential checkpointing of every block")
    ap.add_argument("--remat-policy", default="full",
                    help="full / nothing (recompute the block) or none")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep-last", type=int, default=3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--guard", action="store_true",
                    help="skip NaN/Inf-grad updates on the device, detect "
                         "loss spikes against a rolling median, roll back "
                         "to the last good checkpoint after consecutive "
                         "bad steps")
    ap.add_argument("--guard-window", type=int, default=32)
    ap.add_argument("--guard-spike-factor", type=float, default=4.0)
    ap.add_argument("--guard-rollback-after", type=int, default=3)
    ap.add_argument("--guard-max-rollbacks", type=int, default=5)
    ap.add_argument("--events", default=None,
                    help="append-only JSONL event log: guard verdicts and "
                         "watchdog alerts stream here")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
