"""Serving driver: continuous-batching engine or lockstep demo (counterpart
of ``repro.launch.serve``).

Engine mode (``--engine``) drives ``repro_torch.serve.ServeEngine`` over a
seeded synthetic request trace -- slot-pooled int8 KV cache, FCFS
admission, mid-flight joins and retirements:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --smoke --engine --device cpu

The default (lockstep) mode prefills one fixed batch once and decodes
``--gen`` steps in unison.  Both modes share the seeded sampler
(``--temperature`` / ``--top-k``; greedy is the default).

Runs on the CUDA card by default, where prefill and decode go through the
hand-written kernels; without a card it exits with an error unless
``--device cpu`` asks for the plain versions.  The fleet, journal,
worker, chaos, event and memory-budget flags come with later slices.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.mixed_precision import get_policy
from repro_torch.kernels.kvq import ops as kvq_ops
from repro_torch.models import transformer
from repro_torch.serve import sampling


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks for
    the CPU; no quiet fallback when there is no card."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass --device cpu "
                               "to run the plain PyTorch versions")
        # f32 matmuls and convolutions in full f32, not TF32 (three decimal
        # digits): the f32 policy must mean f32 on the card too
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _kv_banner(cfg, args, s_total: int) -> None:
    if args.no_quantize:
        print(f"kv decode: plain masked softmax (cache not quantized), "
              f"cache {s_total} slots")
        return
    print(f"kv decode: int8 split-K, splits="
          f"{kvq_ops.resolve_splits(s_total, args.kv_splits)} (requested "
          f"{args.kv_splits}, cache {s_total} slots)")


def build_model(args, cfg, device):
    policy = get_policy(args.policy)
    return transformer.init_params(cfg, args.seed, device=device,
                                   dtype=policy.compute_dtype)


def _make_trace(args, cfg, engine):
    from repro_torch.serve import synthetic_trace
    # prompts within the largest bucket, prompt + gen within max_len
    max_prompt = min(engine.buckets[-1], max(4, args.max_len // 2))
    return synthetic_trace(
        args.requests, seed=args.seed, vocab=cfg.vocab,
        mean_prompt=args.mean_prompt, max_prompt=max_prompt,
        mean_gen=args.mean_gen, max_gen=max(1, args.max_len - max_prompt),
        arrival_rate=args.arrival_rate, min_prompt=min(4, max_prompt))


def run_engine(args, cfg, model) -> int:
    from repro_torch.serve import ServeEngine, supports
    if not supports(cfg):
        print(f"engine: {cfg.arch_id} is not engine-eligible")
        return 2
    _kv_banner(cfg, args, args.max_len)
    engine = ServeEngine(
        model, cfg, max_slots=args.max_slots, max_len=args.max_len,
        policy_name=args.policy, quantized=not args.no_quantize,
        kv_splits=args.kv_splits, temperature=args.temperature,
        top_k=args.top_k, seed=args.seed,
        max_prefill_per_step=args.max_prefill_per_step,
        max_queue=args.max_queue or None,
        deadline_steps=(args.deadline_steps
                        if args.deadline_steps >= 0 else None),
        max_retries=args.max_retries)
    print(f"capacity: {engine.pool.bytes_per_slot()/2**20:.2f} MB/slot at "
          f"max_len={args.max_len}, {engine.pool.max_slots} slots")
    t0 = time.time()
    launches = engine.warmup()
    print(f"warmup: {time.time()-t0:.1f}s, kernel launches={launches}")
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
def run_lockstep(args, cfg, model, device) -> int:
    quant = not args.no_quantize
    policy = get_policy(args.policy)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(device)
    s_total = args.prompt_len + args.gen
    _kv_banner(cfg, args, s_total)
    sampler = sampling.make_sampler(temperature=args.temperature,
                                    top_k=args.top_k)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    t0 = time.time()
    logits, aux = transformer.forward(model, cfg, {"tokens": prompts},
                                      policy=policy, build_cache=True,
                                      cache_quantized=quant)
    cache = transformer.grow_cache(aux["cache"], s_total)
    tok = sampler(logits[:, -1], gen)
    out_tokens = [tok.cpu().numpy()]
    t_prefill = time.time() - t0

    t0 = time.time()
    for _ in range(args.gen - 1):
        logits, cache = transformer.decode_step(
            model, cfg, cache, tok, policy=policy, quantized=quant,
            kvq_splits=args.kv_splits)
        tok = sampler(logits, gen)
        out_tokens.append(tok.cpu().numpy())
    t_decode = time.time() - t0

    gen_toks = np.stack(out_tokens, 1)
    print(f"prefill {args.batch}x{args.prompt_len}: {t_prefill*1e3:.0f} ms")
    print(f"decode {args.gen} tok: {t_decode*1e3:.0f} ms "
          f"({t_decode/max(1, args.gen-1)*1e3:.1f} ms/tok, "
          f"{args.batch*(args.gen-1)/max(t_decode, 1e-9):.1f} tok/s)")
    print(f"sample: {gen_toks[0][:12].tolist()}")
    if not ((gen_toks >= 0) & (gen_toks < cfg.vocab)).all():
        raise RuntimeError("sampled a token outside the vocab")
    return 0


def run(args) -> int:
    device = resolve_device(args.device)
    cfg = configs.smoke_config(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    model = build_model(args, cfg, device)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    if args.engine:
        return run_engine(args, cfg, model)
    return run_lockstep(args, cfg, model, device)


def main(argv=None) -> int:
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
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
