"""Trainer, on one device or data-parallel over ranks
(counterpart of ``repro.launch.train``).

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
    steps to a rollback to the last good checkpoint;
  * elastic restarts: the mesh is built from however many ranks there
    are (``launch/mesh.py`` ``make_mesh_for``), and a checkpoint holds
    the global arrays whatever mesh wrote it, so it restores at another
    data width or model width (each rank cuts its block).

Data and tensor parallelism: under ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT`` for
``env://``) the trainer joins a process group, NCCL on the card (rank r
on ``cuda:LOCAL_RANK``) and gloo with ``--device cpu``, and trains on the
mesh ``make_mesh_for(world, max_model=--max-model)``: two ranks make
(data 1, model 2) under the default ``--max-model``, (data 2, model 1)
with ``--max-model 1``.  Every rank draws the same global batch; the
train step takes each rank's rows by its data coordinate, and on a model
axis > 1 each rank holds its block of the weights, the gradients and the
AdamW moments (``train/train_step.py``).  Rank 0 alone prints the step
lines, writes ``--events`` and saves checkpoints, the sharded leaves
gathered to it one at a time (``bridge.export_params(mesh=)``); every
rank waits at a barrier after a save, and every rank restores its block.
The GQA attention archs train on a model axis > 1, the MoE archs among
them (TP-experts, or expert parallelism under ``expert_mode="ep"``; the
banner's ``experts:`` names which), and the SSM mixers (mamba2-130m,
hymba-1.5b: every ``ssm`` leaf whole on every rank) and MLA
(minicpm3-4b: ``q_b`` / ``kv_b`` / ``wo`` by heads); an MoE whose split
dims do not divide the axis exits 2 there, and an encoder
arch exits 2 on any mesh (this trainer's stream has no frames).  Without
that environment the trainer runs one rank, as the mesh (data 1, model
1).

Memory-budgeted training: ``--remat auto`` solves a ``RematPlan`` from
the transformer profile (``repro_torch.plan``): with ``--mem-budget-mb
N`` (which implies the planner) the least recompute whose planned peak
fits N MiB, else sqrt(L) checkpoints at the byte-optimal sites.  The plan
is printed and written to ``remat_plan.json`` in the checkpoint
directory.  ``--remat-policy`` takes every policy of
``core.checkpoint.POLICIES``.  With ``--events F``, ``--trace`` writes
``data`` / ``train_step`` / ``guard`` / ``checkpoint`` spans and
``--metrics-every K`` a ``mem_sample`` (live bytes against the plan's
peak) and a registry snapshot every K steps; ``tools/tracelens.py F``
renders them.

Runs on the CUDA card by default, where attention goes through the
hand-written flash kernels (forward, and delta / dQ / dKV backward);
without a card it exits with an error unless ``--device cpu`` asks for
the plain versions:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --smoke --steps 50 --batch 8 --seq 128 --device cpu \\
      --remat auto --mem-budget-mb 64 --events ev.jsonl --trace \\
      --metrics-every 10

  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --device cpu --smoke --steps 3

qwen2-vl-2b trains here as in the reference: text-only batches, the
positions broadcast over M-RoPE's three streams.  An encoder-decoder
(whisper-base) is refused, since the synthetic stream has no frames (the
reference's trainer fails on them later, in the forward).

Not ported: ``--attn-backend`` (the port dispatches on the device).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import signal
import statistics
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpointing.ckpt import CheckpointManager
from repro_torch.core.checkpoint import POLICIES, CheckpointConfig
from repro_torch.data.synthetic import token_stream
from repro_torch.events import EventSink
from repro_torch.launch.mesh import (describe, init_distributed,
                                     make_mesh_for)
from repro_torch.models import bridge, moe, transformer
from repro_torch.obs import MemStat, MetricsRegistry, Tracer, maybe_span
from repro_torch.optim import adamw
from repro_torch.train.guards import GuardConfig, TrainGuard
from repro_torch.train.train_step import (TrainConfig, init_loss_scale,
                                          make_train_step, plan_profile,
                                          resolve_remat)


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


def _quiet(*_args, **_kwargs):
    """``print`` on the ranks other than 0."""


def _auto_remat(cfg, args, batch_sds, mesh=None, log=print):
    """Planner-driven remat: budget-constrained with ``--mem-budget-mb``
    (through ``train_step.resolve_remat``, the path
    ``TrainConfig.mem_budget_mb`` takes), else sqrt(L) checkpoints at the
    byte-optimal sites.  Either way the profile is the microbatch in the
    policy's compute dtype (``train_step.plan_profile``).  Returns the
    remat config and the plan's peak bytes (what ``MemStat`` scores)."""
    from repro_torch import plan as plan_mod
    base = CheckpointConfig(enabled=True, policy=args.remat_policy)
    tc0 = TrainConfig(policy=args.policy, remat=base, accum=args.accum,
                      mem_budget_mb=args.mem_budget_mb)
    prof = plan_profile(cfg, tc0, batch_sds, mesh=mesh)
    if args.mem_budget_mb > 0:
        remat = resolve_remat(cfg, tc0, batch_sds, mesh=mesh).remat
    else:
        rp = plan_mod.plan_min_peak(prof, math.isqrt(cfg.n_layers) or 1,
                                    policy=args.remat_policy)
        remat = dataclasses.replace(base, plan=rp)
    rep = plan_mod.plan_report(prof, remat.plan)
    log(f"remat plan [{remat.plan.source}]: "
        f"segments {remat.plan.segment_sizes()} "
        f"peak {rep['peak_bytes']/2**20:.1f} MiB/device "
        f"(no-remat {rep['no_remat_bytes']/2**20:.1f} MiB, "
        f"recompute >= {rep['recompute_frac']*100:.0f}% of fwd FLOPs)")
    return remat, int(rep["peak_bytes"])


def init_state(cfg, seed: int, device, mesh=None):
    """Fresh f32 master weights (``requires_grad`` on) and AdamW state:
    this rank's blocks on ``mesh``'s model axis."""
    model = transformer.init_params(cfg, seed, device=device,
                                    dtype=torch.float32,
                                    mesh=mesh).requires_grad_()
    return model, adamw.init(dict(model.named_parameters()))


def train_state(model, opt, mesh=None) -> dict | None:
    """The checkpointed state in the JAX package's layout, the global
    arrays; with ``mesh`` every rank calls it and rank 0 gets the state,
    the others None (only rank 0's model group gathers)."""
    params = bridge.export_params(model, mesh=mesh)
    opt = bridge.export_opt_state(opt, mesh=mesh, cfg=model.cfg)
    return None if params is None else {"params": params, "opt": opt}


def state_like(cfg) -> dict:
    """The global shape of the checkpointed state, at no memory: what a
    checkpoint from any mesh must fit."""
    tree = bridge.abstract_params(cfg)
    return {"params": tree, "opt": adamw.AdamWState(
        mu=tree, nu=tree, count=np.zeros((), np.int32))}


def load_state(cfg, state: dict, device, mesh=None):
    """The global state -> this rank's blocks of the model and moments."""
    model = bridge.load_jax_params(cfg, state["params"], device=device,
                                   mesh=mesh).requires_grad_()
    return model, bridge.load_opt_state(state["opt"], device=device,
                                        cfg=cfg, mesh=mesh)


def run(args) -> int:
    cfg = configs.smoke_config(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    if cfg.encoder is not None:
        # the reference's trainer feeds the same text-only batches and its
        # forward then fails on the missing frames (a KeyError); refuse
        # before building anything
        print(f"{cfg.arch_id}: an encoder-decoder trains on (tokens, "
              f"frames) batches, and this trainer's synthetic stream has "
              f"no frames: not trainable through this CLI (train it with "
              f"train_step on batches that carry 'frames')", file=sys.stderr)
        return 2
    rank, world, device = init_distributed(args.device)
    try:
        mesh = make_mesh_for(world, max_model=args.max_model)
        refusal = _mesh_refusal(cfg, mesh)
        if refusal is not None:
            if rank == 0:
                print(refusal, file=sys.stderr)
            if dist.is_initialized():
                # every rank refuses alike; none tears its connections
                # down while another is still joining the group
                dist.barrier()
            return 2
        return _train(args, cfg, mesh, rank, world, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _mesh_refusal(cfg, mesh) -> str | None:
    """Why ``cfg`` does not train on ``mesh``'s model axis, or None."""
    if mesh.shape["model"] == 1:
        return None
    try:
        transformer.check_mesh(cfg, mesh)
    except (NotImplementedError, ValueError) as e:
        return f"mesh: {describe(mesh)}: {e}; pass --max-model 1"
    return None


def _train(args, cfg, mesh, rank: int, world: int, device) -> int:
    log = print if rank == 0 else _quiet
    log(f"mesh: {describe(mesh)} ({mesh.size} devices)"
        + (f", experts: {moe.describe_layout(cfg, mesh.shape['model'])}"
           if cfg.moe is not None and mesh.shape["model"] > 1 else ""))
    log(f"device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else ""))
    from repro_torch.plan import flash_attn_flop_report
    rep = flash_attn_flop_report(cfg, args.batch, args.seq)
    if rep["eligible"]:
        log(f"attention: flash op (O(S*D) residuals); sparse grids skip "
            f"{rep['skip_frac']*100:.0f}% of KV tile-steps "
            f"({rep['visited_flops']/1e9:.1f} GFLOPs visited vs "
            f"{rep['dense_flops']/1e9:.1f} dense per step)")
    if args.mem_budget_mb > 0:
        from repro_torch.distributed import sharding as shd
        log(f"mem budget: {args.mem_budget_mb} MiB PER DEVICE "
            f"(microbatch = batch / {shd.dp_size(mesh)} dp shards; "
            f"attention residuals / {mesh.shape['model']} model shards)")
    batch_sds = {"tokens": torch.empty((args.batch, args.seq),
                                       dtype=torch.int32, device="meta")}
    if args.no_remat:                     # the JAX trainer's alias
        args.remat = "off"
    if args.remat == "off" and args.mem_budget_mb > 0:
        log("[warn] --mem-budget-mb ignored with remat off")
    plan_bytes = None                     # activation budget (MemStat score)
    if args.remat == "auto" or (args.remat == "on"
                                and args.mem_budget_mb > 0):
        # a budget implies the planner even without an explicit --remat auto
        remat, plan_bytes = _auto_remat(cfg, args, batch_sds, mesh, log)
    else:
        remat = CheckpointConfig(enabled=args.remat == "on",
                                 policy=args.remat_policy)
    tc = TrainConfig(
        policy=args.policy, remat=remat, accum=args.accum,
        use_loss_scale=(args.policy == "fp16"), skip_nonfinite=args.guard,
        opt=adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=min(100, args.steps // 10 + 1)))
    step_fn, tc = make_train_step(cfg, tc, batch_sds, mesh=mesh)
    log(f"policy {args.policy}, remat {args.remat} "
        f"({args.remat_policy}), accum {args.accum}, "
        f"batch {args.batch} x seq {args.seq}")

    mgr = CheckpointManager(args.ckpt_dir, keep_last=args.keep_last)
    if tc.remat.plan is not None and rank == 0:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        tc.remat.plan.save(os.path.join(args.ckpt_dir, "remat_plan.json"))
    model, opt = init_state(cfg, args.seed, device, mesh)
    ls = init_loss_scale(tc, device)
    start_step, data_state = 0, 0

    latest = mgr.latest_intact_step()
    if latest is not None and not args.fresh:
        restored, extra = mgr.restore(latest, state_like(cfg),
                                      config=cfg.arch_id)
        model, opt = load_state(cfg, restored, device, mesh)
        start_step = extra.get("step", latest)
        data_state = extra.get("data_state", 0)
        if tc.use_loss_scale and "loss_scale" in extra:
            ls.scale.fill_(extra["loss_scale"])
        log(f"resumed from step {start_step} (data batch {data_state})")

    stop = {"now": False}

    def _sig(_s, _f):
        print("[signal] preemption notice — checkpoint and exit")
        stop["now"] = True

    old_handlers = [signal.signal(s, _sig) for s in (signal.SIGTERM,
                                                     signal.SIGINT)]

    def save(step):
        # ``step`` = completed steps; a resume continues there.  Every
        # rank calls train_state: rank 0's model group gathers the global
        # state (its blocks, on a model axis), rank 0 writes it, the
        # others wait
        state = train_state(model, opt, mesh)
        if rank == 0:
            with maybe_span(tracer, "checkpoint", step=step, op="save"):
                mgr.save(step, state,
                         extra={"step": step, "data_state": data_state,
                                "loss_scale": float(ls.scale),
                                "arch": cfg.arch_id},
                         config=cfg.arch_id)
        del state
        if world > 1:
            dist.barrier()

    def agreed(flag: bool) -> bool:
        """``flag`` on any rank (MAX over the group): a preemption notice
        one rank saw stops every rank at the same step."""
        if world == 1:
            return flag
        t = torch.tensor([int(flag)], device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    sink = EventSink(args.events) if args.events and rank == 0 else None
    if args.trace and sink is None and rank == 0:
        log("[warn] --trace requires --events; tracing disabled")
    registry = MetricsRegistry()
    tracer = Tracer(sink, pid="train") if args.trace and sink is not None \
        else None
    memstat = MemStat(sink=sink, registry=registry, plan_bytes=plan_bytes,
                      device=device)
    guard = None
    if args.guard:
        guard = TrainGuard(GuardConfig(
            window=args.guard_window, spike_factor=args.guard_spike_factor,
            rollback_after=args.guard_rollback_after), sink=sink,
            registry=registry)
        log(f"guard: skip non-finite steps on the device; loss spike > "
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
            with maybe_span(tracer, "data", step=step):
                data_state, batch = next(data)
            wd.step_start()
            with maybe_span(tracer, "train_step", step=step):
                model, opt, ls, metrics = step_fn(model, opt, ls, batch)
                verdict = TrainGuard.OK
                if guard is not None:
                    # the loss sync closes the step: the span measures
                    # dispatch + device time, not just dispatch
                    with maybe_span(tracer, "guard", step=step):
                        verdict = guard.observe(
                            float(metrics["loss"]),  # sync
                            bool(metrics["grads_finite"]),
                            grad_norm=float(metrics["grad_norm"]))
            if verdict == TrainGuard.ROLLBACK:
                wd.step_end()
                if guard.rollbacks > args.guard_max_rollbacks:
                    log(f"[guard] {guard.rollbacks} rollbacks exceed "
                        f"--guard-max-rollbacks="
                        f"{args.guard_max_rollbacks} — persistent "
                        f"fault, aborting ({guard.counters()})")
                    return 1
                # never roll back onto a torn or corrupt checkpoint
                latest = mgr.latest_intact_step()
                if latest is None:
                    log("[guard] rollback with no checkpoint on disk — "
                        "restarting from init")
                    model, opt = init_state(cfg, args.seed, device, mesh)
                    step, data_state = 0, 0
                else:
                    with maybe_span(tracer, "checkpoint", step=latest,
                                    op="restore"):
                        restored, extra = mgr.restore(
                            latest, state_like(cfg), config=cfg.arch_id)
                    model, opt = load_state(cfg, restored, device, mesh)
                    step = extra.get("step", latest)
                    data_state = extra.get("data_state", 0)
                    if tc.use_loss_scale and "loss_scale" in extra:
                        ls.scale.fill_(extra["loss_scale"])
                guard.reset_history()
                data = synthetic_lm_batches(cfg, args.batch, args.seq,
                                            seed=args.seed, state=data_state,
                                            device=device)
                log(f"[guard] rolled back to step {step} "
                    f"(data batch {data_state}; {guard.counters()})")
                continue
            if verdict == TrainGuard.SKIP:
                applied = bool(metrics["grads_finite"])
                log(f"[guard] step {step}: bad step ({guard.counters()}) "
                    f"— update "
                    f"{'applied; loss quarantined' if applied else 'skipped on the device'}")
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])  # sync point
                log(f"step {step:5d} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"gnorm {float(metrics['grad_norm']):.2f} "
                    f"({(time.time()-t0):.1f}s)")
            wd.step_end()
            data_state += 1
            step += 1
            if args.metrics_every and step % args.metrics_every == 0:
                # allocator counters and a registry snapshot; no sync
                memstat.sample(step)
                if sink is not None:
                    registry.emit(sink, step=step)
            healthy = guard is None or guard.bad_streak == 0
            if step % args.ckpt_every == 0 and healthy:
                # never checkpoint mid-bad-streak: the rollback target
                # must be a good state
                save(step)
            if agreed(stop["now"]):
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
        log(f"guard: {guard.counters()}")
    if memstat.samples:
        log(memstat.banner())
    log("done")
    return 0


def build_parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--max-model", type=int, default=16,
                    help="largest model (tensor-parallel) axis of the mesh "
                         "make_mesh_for builds from the world size: two "
                         "ranks give (data 1, model 2) under the default, "
                         "(data 2, model 1) with --max-model 1; an MoE arch "
                         "splits its experts over the model axis (F, or E "
                         "with expert_mode='ep')")
    ap.add_argument("--policy", default="bf16",
                    choices=["full", "bf16", "fp16", "bf16_params",
                             "resid_bf16"],
                    help="mixed-precision policy; resid_bf16 = f32 compute "
                         "with the flash op's saved (q,k,v,o) residuals "
                         "stored in bf16 (stats stay f32)")
    ap.add_argument("--remat", default="on", choices=["on", "off", "auto"],
                    help="on: sequential checkpointing of every block; "
                         "auto: a profile-driven RematPlan "
                         "(repro_torch.plan)")
    ap.add_argument("--mem-budget-mb", type=int, default=0,
                    help="activation-byte budget; > 0 engages the remat "
                         "planner (with --remat auto, 0 means sqrt(L) "
                         "checkpoints instead)")
    ap.add_argument("--remat-policy", default="full",
                    choices=sorted(POLICIES),
                    help="what a recomputed segment keeps: full / nothing "
                         "(nothing), dots (every product's output), "
                         "dots_nobatch (products without a batch dim), "
                         "none (everything: no recompute)")
    ap.add_argument("--no-remat", action="store_true",
                    help="alias for --remat off (the JAX trainer's flag)")
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
                    help="append-only JSONL event log: guard verdicts, "
                         "watchdog alerts, spans and memory samples "
                         "stream here")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="every N steps: sample live device bytes "
                         "(mem_sample, scored against the plan) and emit a "
                         "metrics_snapshot of the obs registry to --events "
                         "(0 = off)")
    ap.add_argument("--trace", action="store_true",
                    help="emit span_begin/span_end records (data / "
                         "train_step / guard / checkpoint) to --events; "
                         "tools/tracelens.py renders the timeline")
    return ap


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
