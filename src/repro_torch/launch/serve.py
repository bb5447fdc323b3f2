"""Serving driver: continuous-batching engine or lockstep demo (counterpart
of ``repro.launch.serve``).

Engine mode (``--engine``) drives ``repro_torch.serve.ServeEngine`` over a
seeded synthetic request trace -- slot-pooled int8 KV cache, FCFS
admission, mid-flight joins and retirements:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --smoke --engine --device cpu

The default (lockstep) mode prefills one fixed batch once and decodes
``--gen`` steps in unison; it serves every arch, the SSM family
(mamba2-130m, hymba-1.5b), MLA (minicpm3-4b, a bf16 latent cache) and the
encoder-decoder (whisper-base: the encoder runs once in the prefill on
zero frames, as the reference CLI's, and every decode step attends over
its output) included, which the engine refuses:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --smoke --device cpu

Both modes sample from ``--seed`` at ``--temperature`` / ``--top-k``
(greedy is the default): the lockstep batch with one generator, the
engine with per-row keys (``serve/sampling.py``).

Fleet mode (``--engine --replicas N``) fronts N engine replicas with the
health-routing ``repro_torch.serve.Router``: least-loaded admission, an
error-budget circuit breaker per replica, and cross-replica request
migration.  ``--chaos-seed`` runs the seeded chaos harness (replica
crash / sick / slow events) against the fleet; ``--journal wal.jsonl``
writes every fleet request transition ahead to an fsync'd journal, and a
rerun with ``--recover`` rebuilds the fleet from it and finishes every
in-flight request; ``--workers`` runs each replica as a real subprocess
behind the pipe RPC (``repro_torch.serve.worker``), each with its own
weights:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --engine \
        --device cpu --replicas 2 --chaos-seed 0 --journal wal.jsonl

``--events out.jsonl`` streams fault / health / failover events to an
append-only JSONL sink, ``--trace`` adds request spans (queue / prefill /
decode / step / migrate / journal / rpc) and ``--metrics-every N``
registry and memory snapshots; ``tools/tracelens.py`` renders them.

Runs on the CUDA card by default, where prefill and decode go through the
hand-written kernels; without a card it exits with an error unless
``--device cpu`` asks for the plain versions.  ``--mem-budget-mb``
clamps the engine's slots to what that many MB of KV cache admit (the
``capacity:`` line).

Serving over a mesh: under ``torchrun``'s environment the ranks join a
process group (NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``)
and form the mesh ``make_mesh_for(world, max_model=--max-model)``
(banner ``mesh: data=1 x model=2 (2 devices)``).  On a model axis > 1
the engine serves with each rank holding its block of the weights and of
the slot pool, the KV heads or the cache's sequence split over the axis
(``kv cache sharded over '<mode>'``, the budget per device); a data
axis > 1 serves the whole trace in each model group.  Rank 0 alone prints
and writes events:

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu \
        --smoke --engine --max-model 2

An MoE arch serves there with its experts split over the model axis
(TP-experts, or expert parallelism under ``expert_mode="ep"``; the
``experts:`` banner names which).  The fleet (``--replicas`` > 1,
``--journal``) serves there too, as the reference's ``run_fleet`` does:
every replica is an engine on the mesh, every rank runs the same router
and chaos harness over its blocks of them, and the ranks' decision
digests (``Router.decision_digest``) are compared before every router
step (before the engines' collectives could diverge), after a recovery
and at the end: a difference raises on every rank.  Only rank 0 writes
the journal; the others keep a mirror of it in memory
(``RequestJournal.mirror``), from rank 0's state broadcast when it is
opened, so on ``--recover`` every router rebuilds the same requests with
no shared file system.  On a
model axis > 1 the engine exits 2 for an arch it does not take (MLA, the
SSM mixers, the encoder, as on one device), an MoE whose split dims do
not divide the axis and a mesh whose axis splits neither the KV heads
nor ``--max-len``.

Lockstep mode (no ``--engine``) runs unsharded on any mesh, as the
reference's ``run`` gives it no mesh: rank 0 serves on its device and
prints; every other rank builds no model, touches no card, and waits for
rank 0's exit code (a gloo broadcast, the ranks' only traffic), which it
returns silently.  ``--workers`` does the same: the subprocess replicas
stay unsharded, as the reference's, spawned by rank 0, which runs the
router.  So the archs the engine refuses serve on a host with more than
one device:

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu \
        --smoke --arch mamba2-130m
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.device import resolve_device
from repro_torch.core.mixed_precision import get_policy
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.kvq import ops as kvq_ops
from repro_torch.launch.mesh import describe, init_distributed, make_mesh_for
from repro_torch.models import moe, transformer
from repro_torch.obs import MemStat, Tracer
from repro_torch.serve import sampling


def _kv_banner(cfg, args, s_total: int) -> None:
    """Name what decode will run: the int8 split-K kernel only serves a GQA
    cache (an SSM's state and MLA's latents take their own decode
    paths)."""
    if cfg.mla is not None:
        print(f"kv decode: MLA latent attention (bf16 latent cache, plain "
              f"PyTorch as in the reference), cache {s_total} slots")
        return
    if cfg.mixer not in ("attn", "hybrid"):
        print(f"kv decode: n/a (no kvq-layout attention cache), "
              f"cache {s_total} slots")
        return
    if args.no_quantize:
        print(f"kv decode: plain masked softmax (cache not quantized), "
              f"cache {s_total} slots")
        return
    print(f"kv decode: int8 split-K, splits="
          f"{kvq_ops.resolve_splits(s_total, args.kv_splits)} (requested "
          f"{args.kv_splits}, cache {s_total} slots)")


def build_model(args, cfg, device, mesh=None):
    """The weights from ``--seed``; with ``mesh``, this rank's block."""
    policy = get_policy(args.policy)
    return transformer.init_params(cfg, args.seed, device=device,
                                   dtype=policy.compute_dtype, mesh=mesh)


def _fleet_buckets(max_len: int) -> tuple:
    """Fleet prefill buckets: the defaults plus a max_len bucket, so a
    migration or crash-recovery replay (prompt + emitted tokens, up to
    max_len) always fits some bucket instead of going FAILED."""
    from repro_torch.serve import default_buckets
    base = default_buckets(max_len)
    return base if base[-1] >= max_len else base + (max_len,)


def _engine_kwargs(args, *, sampler_keys: str, replay_buckets: bool) -> dict:
    """The ``ServeEngine`` knobs the flags set, shared by in-process
    replicas and the workers' ``engine_factory``."""
    return dict(
        max_slots=args.max_slots, max_len=args.max_len,
        prompt_buckets=(_fleet_buckets(args.max_len)
                        if replay_buckets else None),
        policy_name=args.policy, quantized=not args.no_quantize,
        kv_splits=args.kv_splits, temperature=args.temperature,
        top_k=args.top_k, seed=args.seed,
        max_prefill_per_step=args.max_prefill_per_step,
        mem_budget_bytes=(int(args.mem_budget_mb * 2**20)
                          if args.mem_budget_mb else None),
        max_queue=args.max_queue or None,
        deadline_steps=(args.deadline_steps
                        if args.deadline_steps >= 0 else None),
        max_retries=args.max_retries, sampler_keys=sampler_keys)


def _build_engine(args, cfg, model, *, sink=None, sampler_keys: str = "step",
                  replay_buckets: bool = False, mesh=None):
    from repro_torch.serve import ServeEngine
    return ServeEngine(model, cfg, sink=sink, mesh=mesh,
                       **_engine_kwargs(args, sampler_keys=sampler_keys,
                                        replay_buckets=replay_buckets))


def _worker_kwargs(args) -> dict:
    """The ``engine_factory`` spec for subprocess replicas: each worker
    makes its own weights from ``--seed`` on ``--device``."""
    return dict(arch=args.arch, smoke=args.smoke, init_seed=args.seed,
                device=args.device,
                **_engine_kwargs(args, sampler_keys="request",
                                 replay_buckets=True))


def _make_trace(args, cfg, engine):
    from repro_torch.serve import synthetic_trace
    # prompts within the largest bucket, prompt + gen within max_len
    max_prompt = min(engine.buckets[-1], max(4, args.max_len // 2))
    return synthetic_trace(
        args.requests, seed=args.seed, vocab=cfg.vocab,
        mean_prompt=args.mean_prompt, max_prompt=max_prompt,
        mean_gen=args.mean_gen, max_gen=max(1, args.max_len - max_prompt),
        arrival_rate=args.arrival_rate, min_prompt=min(4, max_prompt))


def _open_sink(args):
    if not args.events:
        return None
    from repro_torch.events import EventSink
    print(f"events: streaming to {args.events}")
    return EventSink(args.events)


def _want_trace(args, sink) -> bool:
    if args.trace and sink is None:
        print("[warn] --trace requires --events; tracing disabled")
        return False
    return bool(args.trace)


def _install_obs_hook(obj, sink, memstat, every: int, snapshot_fn) -> None:
    """Chain a periodic metrics/memory emitter onto ``pre_step`` -- after
    any fault injector, so neither hook clobbers the other."""
    prev = obj.hooks.get("pre_step")

    def _hook(o, _prev=prev):
        if _prev is not None:
            _prev(o)
        if o.step_no and o.step_no % every == 0:
            memstat.sample(o.step_no)
            if sink is not None:
                sink.emit("metrics_snapshot", snapshot=snapshot_fn(),
                          step=o.step_no)

    obj.hooks["pre_step"] = _hook


def _open_journal(path: str, mesh=None):
    """The fleet's write-ahead journal; with ``mesh`` (the fleet's engines
    on a mesh, every rank running a router) rank 0 opens it and
    broadcasts its state, and every other rank keeps a mirror that
    writes nothing."""
    from repro_torch.serve import JournalState, RequestJournal
    if mesh is None:
        return RequestJournal(path, snapshot_every=64)
    journal = RequestJournal(path, snapshot_every=64) \
        if dist.get_rank() == 0 else None
    box = [None if journal is None else journal.state.to_json()]
    dist.broadcast_object_list(box, src=0)
    return journal or RequestJournal.mirror(JournalState.from_json(box[0]),
                                            snapshot_every=64)


def _check_decisions(router, mesh, at: str) -> None:
    """Raise, on every rank, unless every rank's router has made the same
    decisions: its decision count and the head of its
    ``decision_digest``, reduced with one MAX over the world (of each
    value and its negation) on the replicas' device, where the group's
    backend takes it (NCCL has no host tensors); the ranks' digests are
    gathered into the error."""
    if mesh is None:
        return
    mine = torch.tensor([router.n_decisions,
                         int(router.decision_digest()[:15], 16)],
                        device=router.engines[0].device)
    span = torch.cat([mine, -mine])
    dist.all_reduce(span, op=dist.ReduceOp.MAX)
    if torch.equal(span[:2], -span[2:]):
        return
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (router.n_decisions,
                                   router.decision_digest()))
    raise RuntimeError(f"fleet: the ranks' routers decided differently "
                       f"{at} (decisions, digest by rank: {every})")


def _check_every_step(router, mesh) -> None:
    """Chain :func:`_check_decisions` onto the router's ``pre_step`` hook,
    after the chaos harness's and the metrics': a rank whose router
    decided otherwise raises before its engines step, where its
    collectives would no longer match the other ranks'."""
    if mesh is None:
        return
    prev = router.hooks.get("pre_step")

    def hook(r, _prev=prev):
        if _prev is not None:
            _prev(r)
        _check_decisions(r, mesh, f"by router step {r.step_no}")

    router.hooks["pre_step"] = hook


def run_fleet(args, cfg, model, mesh=None) -> int:
    """N engine replicas behind the health-routing Router, optionally
    under the seeded chaos harness, the journal and subprocess workers.
    With ``mesh`` every replica is an engine on it (``model`` this rank's
    block), and every rank runs the same router (the module
    docstring)."""
    from repro_torch.serve import supports
    if not supports(cfg):
        print(f"fleet: {cfg.arch_id} is not engine-eligible")
        return 2
    if args.recover and not args.journal:
        print("--recover needs --journal")
        return 2
    _kv_banner(cfg, args, args.max_len)
    sink = _open_sink(args)
    journal = None
    if args.journal:
        journal = _open_journal(args.journal, mesh)
        print(f"journal: write-ahead log at {args.journal} "
              f"({journal.state.n_live} live requests on open)")
    t0 = time.time()
    if args.workers:
        from repro_torch.serve import spawn_workers
        engines = spawn_workers(args.replicas, kwargs=_worker_kwargs(args))
        for i, w in enumerate(engines):
            w.metrics.replica = i
        print(f"fleet: {args.replicas} subprocess workers "
              f"(pids {[w.pid for w in engines]}) warmed in "
              f"{time.time()-t0:.1f}s "
              f"({engines[0].pool.max_slots} slots each)")
    else:
        engines = []
        for i in range(args.replicas):
            e = _build_engine(args, cfg, model, sink=sink,
                              sampler_keys="request", replay_buckets=True,
                              mesh=mesh)
            e.metrics.replica = i
            e.warmup()
            engines.append(e)
        print(f"fleet: {args.replicas} replicas warmed in "
              f"{time.time()-t0:.1f}s "
              f"({engines[0].pool.max_slots} slots each)")
        if mesh is not None:
            print(f"fleet: every replica on the mesh {describe(mesh)}, kv "
                  f"cache sharded over '"
                  f"{shd.serve_kv_shard(mesh, cfg.n_kv, args.max_len)}'; "
                  f"one router a rank")
    try:
        return _serve_fleet(args, cfg, engines, journal, sink, mesh)
    finally:
        if journal is not None:
            journal.close()
        if args.workers:
            for w in engines:
                w.shutdown()
        if sink is not None:
            sink.close()


def _serve_fleet(args, cfg, engines, journal, sink, mesh=None) -> int:
    from repro_torch.serve import (BreakerConfig, FleetFaultInjector, Router,
                                   chaos_plan, kernel_launches)
    breaker = BreakerConfig(
        window_steps=args.breaker_window,
        degrade_faults=args.breaker_degrade,
        quarantine_faults=args.breaker_quarantine,
        cooldown_steps=args.breaker_cooldown,
        stall_steps=args.breaker_stall)
    router = Router(engines, policy=args.route, breaker=breaker,
                    max_migrations=args.max_migrations, sink=sink,
                    journal=journal,
                    journal_tokens_every=args.journal_tokens_every,
                    digest_decisions=mesh is not None)
    if _want_trace(args, sink):
        # tracers attach after warmup (the warmup probe must not trace)
        # and before recover() so recovery replays get root spans;
        # subprocess workers trace their RPCs from the parent
        for i, e in enumerate(engines):
            e.tracer = Tracer(sink, pid=f"r{i}")
        router.tracer = Tracer(sink, pid="router")
        if journal is not None:
            journal.tracer = Tracer(sink, pid="journal")
        print("trace: span records -> events "
              "(render with tools/tracelens.py)")
    if args.recover:
        info = router.recover()
        print(f"recover: {info['n_recovered']} requests rebuilt from the "
              f"journal ({info['n_done']} already complete on disk, "
              f"{info['n_placed']} re-placed, {info['n_pending']} pending, "
              f"{info['n_failed']} failed)")
        _check_decisions(router, mesh, "in the recovery")
    if args.chaos_seed >= 0:
        plan = chaos_plan(args.chaos_seed, steps=max(8, args.requests),
                          replicas=args.replicas,
                          n_events=args.chaos_events)
        FleetFaultInjector(router, plan)
        print(f"chaos: seed {args.chaos_seed} -> {dict(plan.counts())}")
    memstat = None
    if args.metrics_every:
        memstat = MemStat(sink=sink, device=args.device,
                          plan_bytes=(int(args.mem_budget_mb * 2**20)
                                      or None))
        _install_obs_hook(router, sink, memstat, args.metrics_every,
                          router.registry_snapshot)
    trace = _make_trace(args, cfg, engines[0])
    _check_every_step(router, mesh)
    t0 = time.time()
    summary = router.run(trace)
    wall = time.time() - t0
    _check_decisions(router, mesh, "over the trace")
    fleet = summary["fleet"]
    print(f"fleet trace: {args.requests} requests in {wall:.2f}s; "
          f"health={summary['health']}")
    print(f"throughput: {summary['tokens_per_s']:.1f} tok/s, goodput "
          f"{summary['goodput_tokens_per_s']:.1f} tok/s "
          f"({summary['total_tokens']} tokens)")
    print(f"failover: {fleet['failovers']} failovers, "
          f"{fleet['n_migrations']} migrations, replay success "
          f"{fleet['replay_success_rate']:.2f}, quarantine steps "
          f"{summary['time_in_quarantine']}")
    print(f"outcomes: done {fleet['n_done']} dropped {fleet['n_dropped']} "
          f"cancelled {fleet['n_cancelled']} failed {fleet['n_failed']} "
          f"rejected {fleet['n_rejected']}")
    if fleet["n_recovered"]:
        print(f"recovery: {fleet['n_recovered']} recovered, replay "
              f"success {fleet['recovery_replay_success']:.2f}")
    # in-process replicas share this process's counters; a worker has its own
    print("kernel launches: "
          + (str([w.kernel_launches() for w in engines]) if args.workers
             else str(kernel_launches())))
    if memstat is not None and memstat.samples:
        print(memstat.banner())
    if mesh is not None:
        print(f"decisions: {router.n_decisions}, equal on every rank "
              f"(digest {router.decision_digest()[:16]})")
    if journal is not None:
        st = journal.state
        print(f"journal: {journal.appends} appends, "
              f"{journal.snapshots} snapshots, {st.n_submits} submits -> "
              f"{st.n_terminals} terminals (+{st.n_live} live)")
    if summary["stalled"]:
        print("STALLED fleet run")
        return 1
    rec = summary["reconcile"]
    if not rec["ok"]:
        raise RuntimeError(f"fleet ledger does not reconcile: {rec}")
    for e in engines:
        if e.pool.occupancy or e.pool.allocs != e.pool.frees:
            raise RuntimeError("slot leak")
    return 0


def run_engine(args, cfg, model, mesh=None) -> int:
    from repro_torch.serve import supports
    if not supports(cfg):
        print(f"engine: {cfg.arch_id} is not engine-eligible (needs a "
              f"uniform-window GQA int8 attention cache; MLA's latent "
              f"cache, SSM and hybrid archs and the encoder-decoder serve "
              f"in lockstep mode)")
        return 2
    _kv_banner(cfg, args, args.max_len)
    sink = _open_sink(args)
    try:
        return _serve_engine(args, cfg, model, sink, mesh)
    finally:
        if sink is not None:
            sink.close()


def _serve_engine(args, cfg, model, sink, mesh=None) -> int:
    budget = (int(args.mem_budget_mb * 2**20)
              if args.mem_budget_mb else None)
    engine = _build_engine(args, cfg, model, sink=sink, mesh=mesh)
    per = engine.pool.bytes_per_slot_per_device() / 2**20
    if mesh is not None:
        print(f"mesh: {describe(mesh)}, kv cache sharded over "
              f"'{shd.serve_kv_shard(mesh, cfg.n_kv, args.max_len)}', "
              f"{per:.2f} MB/slot PER DEVICE"
              + (f", experts: {moe.describe_layout(cfg, mesh.shape['model'])}"
                 if cfg.moe is not None and mesh.shape["model"] > 1 else ""))
    dev = "/device" if mesh is not None else ""
    print(f"capacity: {per:.2f} MB/slot{dev} at max_len={args.max_len}"
          + (f" -> budget {args.mem_budget_mb} MB"
             f"{' per device' if mesh is not None else ''} admits "
             f"{engine.pool.max_slots} of {args.max_slots} requested slots"
             if budget else f", {engine.pool.max_slots} slots"))
    t0 = time.time()
    launches = engine.warmup()
    print(f"warmup: {time.time()-t0:.1f}s, kernel launches={launches}")
    if _want_trace(args, sink):
        engine.tracer = Tracer(sink, pid="r0")   # attached after warmup
        print("trace: span records -> events "
              "(render with tools/tracelens.py)")
    memstat = None
    if args.metrics_every:
        memstat = MemStat(sink=sink, plan_bytes=budget, device=args.device,
                          registry=engine.metrics.registry)
        _install_obs_hook(engine, sink, memstat, args.metrics_every,
                          engine.metrics.registry_snapshot)
    trace = _make_trace(args, cfg, engine)
    t0 = time.time()
    summary = engine.run(trace)
    wall = time.time() - t0
    diag = summary["diagnostics"]
    print(f"trace: {args.requests} requests in {wall:.2f}s "
          f"({summary['n_steps']} engine steps, {diag['prefills']} "
          f"prefills, {diag['decode_rounds']} decode rounds)")
    print(f"throughput: {summary['tokens_per_s']:.1f} tok/s "
          f"({summary['total_tokens']} tokens)")
    print(f"ttft: mean {summary['ttft_mean_s']*1e3:.1f} ms "
          f"(p95 {summary['ttft_p95_s']*1e3:.1f} ms, "
          f"{summary['ttft_mean_steps']:.1f} steps); "
          f"itl: {summary['itl_mean_s']*1e3:.1f} ms")
    print(f"occupancy: {summary['occupancy_mean']:.2f}/"
          f"{engine.pool.max_slots} slots "
          f"(queue depth mean {summary['queue_depth_mean']:.2f}, "
          f"max {summary['queue_depth_max']})")
    print(f"kernel launches: {diag['kernel_launches']}")
    failures = (summary["n_cancelled"] + summary["n_dropped"]
                + summary["n_failed"])
    if failures or summary["n_rejected"] or summary["n_faults"]:
        print(f"failure paths: dropped {summary['n_dropped']} "
              f"cancelled {summary['n_cancelled']} "
              f"failed {summary['n_failed']} "
              f"rejected {summary['n_rejected']} "
              f"(faults {summary['n_faults']}, "
              f"retries {summary['n_retried']})")
    if memstat is not None and memstat.samples:
        print(memstat.banner())
    if summary["stalled"]:
        print(f"STALLED: {diag}")
        return 1
    # every trace request is accounted for: finished, shed or rejected
    if summary["n_done"] + failures + summary["n_rejected"] != args.requests:
        raise RuntimeError(f"requests unaccounted for: {summary}")
    if engine.pool.occupancy or engine.pool.allocs != engine.pool.frees:
        raise RuntimeError("slot leak")
    return 0


@torch.no_grad()
def lockstep(args, cfg, model, device, frames=None) -> dict:
    """Prefill one seeded (batch, prompt_len) batch, then decode ``gen - 1``
    steps in unison.  Returns the host-clock times (each ends in a copy of
    the sampled tokens to the host, so the device work is done) and the
    (batch, gen) generated tokens.

    An encoder arch's encoder runs once, in the prefill (its time
    included), on ``frames`` (batch, n_frames, d_model; default zeros, as
    the reference CLI feeds), and every decode step takes its output as
    ``enc_out``.  The reference CLI hands the raw frames to the decode
    steps instead, which is the encoder's output only for zero frames."""
    quant = not args.no_quantize
    policy = get_policy(args.policy)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(device)
    batch = {"tokens": prompts}
    if cfg.encoder is not None:
        batch["frames"] = frames if frames is not None else torch.zeros(
            (args.batch, cfg.encoder.n_frames, cfg.d_model), device=device)
    s_total = args.prompt_len + args.gen
    sampler = sampling.make_sampler(temperature=args.temperature,
                                    top_k=args.top_k)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    t0 = time.time()
    logits, aux = transformer.forward(model, cfg, batch, policy=policy,
                                      build_cache=True, cache_quantized=quant)
    cache = transformer.grow_cache(aux["cache"], s_total)
    enc_out = aux.get("enc_out")
    tok = sampler(logits[:, -1], gen)
    del logits, aux
    out_tokens = [tok.cpu().numpy()]
    t_prefill = time.time() - t0

    t0 = time.time()
    for _ in range(args.gen - 1):
        logits, cache = transformer.decode_step(
            model, cfg, cache, tok, policy=policy, quantized=quant,
            kvq_splits=args.kv_splits, enc_out=enc_out)
        tok = sampler(logits, gen)
        out_tokens.append(tok.cpu().numpy())
    t_decode = time.time() - t0
    return {"prefill_s": t_prefill, "decode_s": t_decode,
            "tokens": np.stack(out_tokens, 1)}


def run_lockstep(args, cfg, model, device) -> int:
    _kv_banner(cfg, args, args.prompt_len + args.gen)
    if cfg.encoder is not None:
        print(f"encoder: {cfg.encoder.n_layers} layers over "
              f"{cfg.encoder.n_frames} zero frames, once in the prefill; "
              f"cross-attention K/V projected from its output every step")
    r = lockstep(args, cfg, model, device)
    t_decode, gen_toks = r["decode_s"], r["tokens"]
    print(f"prefill {args.batch}x{args.prompt_len}: "
          f"{r['prefill_s']*1e3:.0f} ms")
    print(f"decode {args.gen} tok: {t_decode*1e3:.0f} ms "
          f"({t_decode/max(1, args.gen-1)*1e3:.1f} ms/tok, "
          f"{args.batch*(args.gen-1)/max(t_decode, 1e-9):.1f} tok/s)")
    print(f"sample: {gen_toks[0][:12].tolist()}")
    if not ((gen_toks >= 0) & (gen_toks < cfg.vocab)).all():
        raise RuntimeError("sampled a token outside the vocab")
    return 0


def _mesh_refusal(args, cfg, mesh) -> str | None:
    """Why the engine does not serve ``args`` on a model axis > 1, or
    None."""
    n = mesh.shape["model"]
    try:
        transformer.check_mesh(cfg, mesh)
    except (NotImplementedError, ValueError) as e:
        return f"mesh: {describe(mesh)}: {e}; pass --max-model 1"
    from repro_torch.serve import supports
    if not supports(cfg):
        return (f"mesh: {describe(mesh)}: the engine does not take "
                f"{cfg.arch_id}, which is not engine-eligible (MLA's latent "
                f"cache, SSM, hybrid or encoder-decoder; as on one device): "
                f"drop --engine, lockstep serves it unsharded on any mesh, "
                f"or pass --max-model 1")
    if shd.serve_kv_shard(mesh, cfg.n_kv, args.max_len) == "none":
        return (f"mesh: {describe(mesh)}: neither {cfg.n_kv} KV heads nor "
                f"--max-len {args.max_len} split over a model axis of {n}")
    return None


def run(args) -> int:
    if (not args.engine or args.workers) and "RANK" in os.environ \
            and "WORLD_SIZE" in os.environ:
        return _rank0_serves(args)
    rank, world, device = init_distributed(args.device)
    try:
        if rank == 0:
            rc = _run(args, world, device)
        else:
            # rank 0 alone prints and writes events
            args.events = ""
            with open(os.devnull, "w") as null, \
                    contextlib.redirect_stdout(null):
                rc = _run(args, world, device)
        if rc == 2 and dist.is_initialized():
            # every rank refuses alike; none tears its connections down
            # while another is still joining the group
            dist.barrier()
        return rc
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rank0_serves(args) -> int:
    """Lockstep, or the fleet of subprocess workers, under ``torchrun``'s
    environment, unsharded on any mesh (the reference's ``run`` gives
    lockstep no mesh, and its workers stay unsharded): the ranks join a
    gloo group; rank 0 serves on its device (``cuda:LOCAL_RANK``, or the
    CPU) and prints; every other rank builds nothing, touches no card and
    waits for rank 0's exit code, broadcast when rank 0 has ended (1 if
    it raised), and returns it."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method="env://", rank=rank,
                            world_size=world)
    rc = torch.ones(1, dtype=torch.int32)
    try:
        if rank != 0:
            dist.broadcast(rc, 0)
            return int(rc)
        try:
            device = resolve_device(args.device)
            if device.type == "cuda":
                device = torch.device("cuda",
                                      int(os.environ.get("LOCAL_RANK", 0)))
                torch.cuda.set_device(device)
            rc[0] = _run(args, world, device)
        finally:
            dist.broadcast(rc, 0)
        return int(rc)
    finally:
        dist.destroy_process_group()


def _run(args, world: int, device) -> int:
    mesh = make_mesh_for(world, max_model=args.max_model)
    print(f"mesh: {describe(mesh)} ({mesh.size} devices)")
    cfg = configs.smoke_config(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    if not args.engine and mesh.size > 1:
        print(f"lockstep: unsharded on rank 0's device; the other "
              f"{mesh.size - 1} ranks wait")
    if args.engine and args.workers and mesh.size > 1:
        print(f"fleet: subprocess workers, unsharded, spawned by rank 0; "
              f"the other {mesh.size - 1} ranks wait")
    on_mesh = args.engine and not args.workers and mesh.size > 1
    tp = on_mesh and mesh.shape["model"] > 1
    if tp:
        why = _mesh_refusal(args, cfg, mesh)
        if why is not None:
            print(why, file=sys.stderr)
            return 2
    # subprocess workers make their own weights; the parent holds none
    model = None if args.engine and args.workers else \
        build_model(args, cfg, device, mesh if tp else None)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    if args.engine:
        on = mesh if on_mesh else None
        if args.replicas > 1 or args.workers or args.journal:
            # journal and worker modes always go through the router: a
            # single replica is a fleet of one
            return run_fleet(args, cfg, model, on)
        return run_engine(args, cfg, model, on)
    return run_lockstep(args, cfg, model, device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (the plain "
                         "PyTorch versions)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--policy", default="bf16")
    ap.add_argument("--kv-splits", type=int, default=1,
                    help="split-K fan-out of the decode kernel (clamped to "
                         "the cache's KV tile count)")
    ap.add_argument("--no-quantize", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy, the default)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the top-k logits (0 = all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-model", type=int, default=16,
                    help="largest model axis of the mesh over torchrun's "
                         "ranks (launch/mesh.py make_mesh_for); an MoE arch "
                         "splits its experts over it (F, or E with "
                         "expert_mode='ep')")
    # -- continuous-batching engine mode ----------------------------------
    ap.add_argument("--engine", action="store_true",
                    help="serve a synthetic request trace through the "
                         "continuous-batching engine")
    ap.add_argument("--requests", type=int, default=16,
                    help="engine: number of trace requests")
    ap.add_argument("--max-slots", type=int, default=4,
                    help="engine: resident request slots in the KV pool")
    ap.add_argument("--max-len", type=int, default=128,
                    help="engine: per-slot cache length (prompt + gen cap)")
    ap.add_argument("--mean-prompt", type=int, default=24,
                    help="engine: mean trace prompt length")
    ap.add_argument("--mean-gen", type=int, default=12,
                    help="engine: mean trace generation length")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="engine: trace arrivals per engine step")
    ap.add_argument("--max-prefill-per-step", type=int, default=1,
                    help="engine: prefill-vs-decode interleave quota")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="engine: bounded queue depth (0 = unbounded)")
    ap.add_argument("--deadline-steps", type=int, default=-1,
                    help="engine: queue TTL in engine steps (-1 = none)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="engine: replay budget per request after a "
                         "detected decode fault")
    ap.add_argument("--mem-budget-mb", type=float, default=0.0,
                    help="engine: KV-cache byte budget; clamps the slots to "
                         "what it admits (0 = no budget)")
    ap.add_argument("--events", default="",
                    help="append fault / health / failover events to this "
                         "JSONL file (repro_torch.events.EventSink)")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="every N steps: a mem_sample and a "
                         "metrics_snapshot of the obs registry to --events "
                         "(0 = off)")
    ap.add_argument("--trace", action="store_true",
                    help="emit span_begin / span_end records (queue / "
                         "prefill / decode / step / migrate / journal / rpc) "
                         "to --events; tools/tracelens.py renders them")
    # -- replica fleet (router) --------------------------------------------
    ap.add_argument("--replicas", type=int, default=1,
                    help="fleet: engine replicas behind the router "
                         "(1 = plain single-engine mode)")
    ap.add_argument("--route", default="least_loaded",
                    choices=["least_loaded", "round_robin"],
                    help="fleet: admission routing policy")
    ap.add_argument("--max-migrations", type=int, default=2,
                    help="fleet: cross-replica moves per request before "
                         "it FAILs at fleet level")
    ap.add_argument("--breaker-window", type=int, default=32,
                    help="fleet: circuit-breaker fault window (steps)")
    ap.add_argument("--breaker-degrade", type=int, default=1,
                    help="fleet: faults in window -> DEGRADED")
    ap.add_argument("--breaker-quarantine", type=int, default=3,
                    help="fleet: faults in window -> QUARANTINED")
    ap.add_argument("--breaker-cooldown", type=int, default=16,
                    help="fleet: quarantine steps before probation rejoin")
    ap.add_argument("--breaker-stall", type=int, default=8,
                    help="fleet: no-progress steps -> QUARANTINED")
    ap.add_argument("--chaos-seed", type=int, default=-1,
                    help="fleet: run the seeded chaos harness (replica "
                         "crash / sick / slow; -1 = off)")
    ap.add_argument("--chaos-events", type=int, default=3,
                    help="fleet: chaos events to schedule")
    # -- durability (write-ahead journal + subprocess workers) -------------
    ap.add_argument("--journal", default="",
                    help="fleet: write-ahead request journal (JSONL, "
                         "fsync'd); reopening an existing journal replays "
                         "it")
    ap.add_argument("--workers", action="store_true",
                    help="fleet: run each replica as a real subprocess "
                         "behind the pipe RPC (repro_torch.serve.worker)")
    ap.add_argument("--recover", action="store_true",
                    help="fleet: rebuild in-flight requests from the "
                         "--journal before serving the trace (whole-router "
                         "crash recovery)")
    ap.add_argument("--journal-tokens-every", type=int, default=1,
                    help="fleet: journal token deltas every N router steps "
                         "(lost tail tokens are regenerated on recovery)")
    return ap


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
