#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA card (an H100 for the kernels' ``sm_90a`` target) and the
CUDA toolkit; imports nothing of JAX or of the JAX package.  Prints one
JSON object per line:

1. ``device``: the card, and ``nvidia-smi``'s name and power limit;
2. ``build``: the hand-written kernels of ``src/repro_torch/kernels/csrc``
   compiled with one ``nvcc`` each, all started together, and the seconds
   it took;
3. ``kernel`` lines: each kernel against its plain PyTorch version on the
   card at the serving path's shapes, with its tolerance, its visit
   counters against the ``tiling`` twins, and its time (CUDA events around
   one call queued behind a device spin, median of 25 calls after warm-up,
   L2 flushed before each), the plain
   version's time, the bound (the larger of bytes over 3.35 TB/s and
   operations over the peak rate of their type) and, for flash, the time of
   ``F.scaled_dot_product_attention`` as a yardstick the port never calls;
4. ``model``: a 2-layer model at head_dim 128 run through prefill and
   decode on the card (kernels) and on the CPU (plain versions) from the
   same weights, logits and int8 caches compared;
5. ``serve``: the full-width, full-depth llama3-8b (random bf16 weights from
   ``--seed``) served by ``ServeEngine`` over a 16-request synthetic trace;
   the kernels' launch counters are zeroed just before the run and read
   just after it;
6. ``profile``: ``torch.profiler`` over a short serve run after that one,
   device time by kernel and the card's idle share;
7. the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises after the lines are printed, and the script exits
non-zero without the final ``ok`` line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense; f32 off-TC
L2_FLUSH_BYTES = 256 * 2**20     # > the 50 MB L2
SLEEP_CYCLES = 2_000_000         # ~1 ms of device spin before each timing

FLASH_SRC = "src/repro_torch/kernels/csrc/flash_fwd.cu"
DECODE_SRC = "src/repro_torch/kernels/csrc/flash_decode.cu"
FLASH_TPU = "src/repro/kernels/flash/kernel.py:175"
DECODE_TPU = "src/repro/kernels/kvq/kernel.py:163"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class Smoke:
    def __init__(self, args):
        import torch
        self.torch = torch
        self.args = args
        self.dev = torch.device("cuda", 0)
        self.failures: list[str] = []
        self.records: list[dict] = []
        self._flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                      device=self.dev)

    # -- helpers -----------------------------------------------------------
    def sync(self):
        self.torch.cuda.synchronize(self.dev)

    def record(self, obj: dict) -> dict:
        self.records.append(obj)
        emit(obj)
        if not obj.get("ok", True):
            self.failures.append(f"{obj.get('phase')}: {obj}")
        return obj

    def time_ms(self, fn, n: int = 25, warmup: int = 3) -> float:
        """Median device time of ``fn`` over ``n`` calls, L2 flushed
        before each (the serving path meets these operands cold)."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(n):
            self._flush_buf.zero_()
            # keep the card busy while the host enqueues fn, so the events
            # time device work and not Python dispatch
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    # -- phases ------------------------------------------------------------
    def check_flash(self, s: int, dtype, window: int = 0) -> dict:
        torch = self.torch
        from repro_torch.kernels.flash import ops, ref
        b, h, hkv, d = 1, 32, 8, 128
        gen = torch.Generator(device=self.dev).manual_seed(s + window)
        q = torch.randn((b * h, s, d), generator=gen, device=self.dev,
                        dtype=dtype)
        k = torch.randn((b * hkv, s, d), generator=gen, device=self.dev,
                        dtype=dtype)
        v = torch.randn((b * hkv, s, d), generator=gen, device=self.dev,
                        dtype=dtype)
        o, m, l, cnt = ops.flash_attention_fwd(q, k, v, causal=True,
                                               window=window, counts=True)
        o_r, m_r, l_r = ref.flash_fwd_ref(q, k, v, causal=True,
                                          window=window)
        self.sync()
        err = float((o.float() - o_r.float()).abs().max())
        err_m = float((m - m_r).abs().max())
        err_l = float(((l - l_r).abs() / l_r).max())
        want = ops.expected_counts(s, window=window)
        counts_ok = cnt.cpu().tolist() == [want] * (b * h)
        # bf16: kernel and plain both compute in f32 from the same bf16
        # inputs and each rounds o once to bf16; |o| < 4, so one bf16 ulp
        # (2^-8 relative) bounds the gap.  f32: summation order only.
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        ok = err <= tol and err_m <= 1e-3 and err_l <= 1e-3 and counts_ok

        ms = self.time_ms(lambda: ops.flash_attention_fwd(
            q, k, v, causal=True, window=window))
        plain_ms = self.time_ms(lambda: ref.flash_fwd_ref(
            q, k, v, causal=True, window=window), n=20)
        library_ms = None
        if window == 0:
            q4, k4, v4 = (x.reshape(b, -1, s, d) for x in (q, k, v))
            library_ms = self.time_ms(lambda: self._sdpa(q4, k4, v4))
        # work this run's inputs need: keys each query row attends to
        keys = sum(min(i + 1, window) if window else i + 1 for i in range(s))
        flops = 4 * b * h * d * keys
        es = q.element_size()
        nbytes = (2 * b * h * s * d + 2 * b * hkv * s * d) * es \
            + 2 * b * h * s * 4
        dname = str(dtype).removeprefix("torch.")
        t_ops = flops / PEAK_FLOPS[dname] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return self.record({
            "phase": "kernel", "name": "flash_fwd", "ok": ok,
            "shape": {"B": b, "H": h, "Hkv": hkv, "D": d, "S": s,
                      "window": window, "dtype": dname},
            "max_abs_err": err, "tol": tol, "max_abs_err_m": err_m,
            "max_rel_err_l": err_l, "counts_ok": counts_ok,
            "counts_per_head": want, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes})

    def _sdpa(self, q, k, v):
        import torch.nn.functional as F
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    def check_decode(self, splits: int) -> dict:
        torch = self.torch
        from repro_torch.kernels import tiling
        from repro_torch.kernels.kvq import ops, ref
        b, hkv, g, d, s = 8, 8, 4, 128, 2048
        lengths_list = [1, 2048, 513, 512, 7, 1500, 1024, 64]
        gen = torch.Generator(device=self.dev).manual_seed(splits)
        q = torch.randn((b, hkv * g, d), generator=gen, device=self.dev)
        kq, ks = ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=self.dev))
        vq, vs = ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=self.dev))
        lengths = torch.tensor(lengths_list, dtype=torch.int32,
                               device=self.dev)
        out, cnt = ops.decode_attention(q, kq, ks, vq, vs, lengths=lengths,
                                        splits=splits, counts=True)
        qg = q.reshape(b, hkv, g, d)
        sm = d ** -0.5
        if splits == 1:
            plain = lambda: ref.decode_attention_ref(  # noqa: E731
                qg, kq, ks, vq, vs, None, sm, lengths=lengths)
        else:
            plain = lambda: ref.decode_attention_splitk_ref(  # noqa: E731
                qg, kq, ks, vq, vs, sm, lengths=lengths, splits=splits)
        out_r = plain().reshape(b, hkv * g, d)
        self.sync()
        err = float((out - out_r).abs().max())
        twin = tiling.decode_tile_step_counts(s, lengths_list, splits=splits)
        want = [[row] * hkv for row in twin["counts"]]
        counts_ok = cnt.cpu().tolist() == want
        tol = 1e-4                 # f32 both; summation order only
        ok = err <= tol and counts_ok
        ms = self.time_ms(lambda: ops.decode_attention(
            q, kq, ks, vq, vs, lengths=lengths, splits=splits))
        plain_ms = self.time_ms(plain, n=20)
        live = sum(lengths_list)
        nbytes = hkv * live * (2 * d + 8) + q.numel() * 4 * 2 + b * 4
        flops = 4 * hkv * g * d * live
        t_ops = flops / PEAK_FLOPS["float32"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return self.record({
            "phase": "kernel", "name": "flash_decode", "ok": ok,
            "shape": {"B": b, "Hkv": hkv, "G": g, "D": d, "S": s,
                      "splits": twin["splits"], "lengths": lengths_list},
            "max_abs_err": err, "tol": tol, "counts_ok": counts_ok,
            "tiles_visited": twin["visited"] * hkv,
            "tiles_dense": twin["dense"] * hkv,
            "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes})

    def check_model(self) -> dict:
        """A 2-layer model through prefill + decode on the card (kernels)
        and on the CPU (plain versions), same weights, f32 policy."""
        import numpy as np
        torch = self.torch
        from repro_torch import configs
        from repro_torch.core.mixed_precision import Policy
        from repro_torch.models import bridge, transformer as tf
        cfg = dataclasses.replace(
            configs.get_config("llama3-8b"), n_layers=2, d_model=512,
            n_heads=4, n_kv=1, head_dim=128, d_ff=1024, vocab=1000)
        cpu = tf.init_params(cfg, self.args.seed, device="cpu")
        gpu = bridge.load_jax_params(cfg, bridge.export_params(cpu),
                                     device=self.dev)
        rng = np.random.default_rng(self.args.seed)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 100))
                                  .astype(np.int32))
        pol = Policy.full()
        with torch.no_grad():
            want, aux_c = tf.forward(cpu, cfg, {"tokens": tokens},
                                     policy=pol, build_cache=True)
            got, aux_g = tf.forward(gpu, cfg, {"tokens": tokens.to(self.dev)},
                                    policy=pol, build_cache=True)
            live = slice(0, cfg.vocab)
            rel = lambda a, b: float(  # noqa: E731
                (a.cpu() - b).abs().max() / b.abs().max())
            prefill_err = rel(got[..., live], want[..., live])
            cache_c = tf.grow_cache(aux_c["cache"], 1024)
            cache_g = {n: t.to(self.dev) for n, t in cache_c.items()}
            off = [int((aux_g["cache"][n].cpu().int()
                        - aux_c["cache"][n].int()).abs().gt(0).sum())
                   for n in ("k", "v")]
            off_frac = sum(off) / (2 * aux_c["cache"]["k"].numel())
            pos = torch.tensor([100, 60], dtype=torch.int32)
            cache_c["pos"], cache_g["pos"] = pos, pos.to(self.dev)
            decode_err = 0.0
            for _ in range(4):
                toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2,))
                                        .astype(np.int32))
                act = torch.tensor([True, True])
                lw, cache_c = tf.decode_step(cpu, cfg, cache_c, toks,
                                             policy=pol, active=act)
                lg, cache_g = tf.decode_step(gpu, cfg, cache_g,
                                             toks.to(self.dev), policy=pol,
                                             kvq_splits=2,
                                             active=act.to(self.dev))
                decode_err = max(decode_err, rel(lg[:, live], lw[:, live]))
        self.sync()
        ok = prefill_err <= 1e-4 and decode_err <= 1e-3 and off_frac <= 1e-3
        return self.record({
            "phase": "model", "ok": ok, "cfg": {
                "n_layers": 2, "d_model": 512, "n_heads": 4, "n_kv": 1,
                "head_dim": 128, "vocab": 1000, "prompt": [2, 100]},
            "prefill_logits_rel_err": prefill_err, "prefill_tol": 1e-4,
            "int8_cache_off_by_one_frac": off_frac,
            "decode_logits_rel_err": decode_err, "decode_tol": 1e-3})

    def run_serve(self) -> dict:
        torch = self.torch
        from repro_torch import configs
        from repro_torch.kernels.flash import ops as flash_ops
        from repro_torch.kernels.kvq import ops as kvq_ops
        from repro_torch.models import transformer
        from repro_torch.serve import (ServeEngine, kernel_launches,
                                       synthetic_trace)
        cfg = configs.get_config("llama3-8b")
        t0 = time.time()
        model = transformer.init_params(cfg, self.args.seed, device=self.dev,
                                        dtype=torch.bfloat16)
        self.sync()
        init_s = time.time() - t0
        engine = ServeEngine(model, cfg, max_slots=8, max_len=2048,
                             policy_name="bf16", quantized=True, kv_splits=4)
        t0 = time.time()
        engine.warmup()
        self.sync()
        warmup_s = time.time() - t0
        trace = synthetic_trace(16, seed=0, vocab=cfg.vocab, mean_prompt=256,
                                max_prompt=1024, mean_gen=32, max_gen=64)
        torch.cuda.reset_peak_memory_stats(self.dev)
        flash_ops.KERNEL.launches = 0          # the main path's counts
        kvq_ops.KERNEL.launches = 0
        t0 = time.time()
        summary = engine.run(trace)
        self.sync()
        wall = time.time() - t0
        launches = kernel_launches()
        diag = summary["diagnostics"]
        tokens = [t for r in engine._requests_done for t in r.tokens]
        L = cfg.n_layers
        checks = {
            "n_done": summary["n_done"] == len(trace),
            "no_faults": summary["n_faults"] == 0,
            "tokens_in_vocab": all(0 <= t < cfg.vocab for t in tokens),
            "flash_launches": launches["flash_fwd"] == L * diag["prefills"]
            and launches["flash_fwd"] > 0,
            "decode_launches": launches["flash_decode"]
            == L * diag["decode_rounds"] and launches["flash_decode"] > 0,
            "no_slot_leak": engine.pool.occupancy == 0
            and engine.pool.allocs == engine.pool.frees,
            "not_stalled": not summary["stalled"],
        }
        self.serve_launches = launches
        rec = self.record({
            "phase": "serve", "ok": all(checks.values()), "checks": checks,
            "arch": cfg.arch_id, "n_layers": L, "d_model": cfg.d_model,
            "max_slots": 8, "max_len": 2048, "policy": "bf16",
            "kv_splits": 4, "n_requests": len(trace),
            "n_done": summary["n_done"], "n_faults": summary["n_faults"],
            "total_tokens": summary["total_tokens"],
            "prefills": diag["prefills"],
            "decode_rounds": diag["decode_rounds"],
            "kernel_launches": launches, "wall_s": wall,
            "tokens_per_s": summary["tokens_per_s"],
            "ttft_mean_s": summary["ttft_mean_s"],
            "ttft_p95_s": summary["ttft_p95_s"],
            "itl_mean_s": summary["itl_mean_s"],
            "occupancy_mean": summary["occupancy_mean"],
            "max_memory_allocated_bytes":
                torch.cuda.max_memory_allocated(self.dev),
            "kv_pool_bytes": engine.pool.bytes_per_slot() * 8,
            "init_s": init_s, "warmup_s": warmup_s})
        self.profile_serve(engine, cfg)
        return rec

    def profile_serve(self, engine, cfg) -> dict:
        """Where a serving step's device time goes: ``torch.profiler`` over
        8 requests (prompt 256, 16 new tokens) served after the measured
        run, device time summed by kernel name."""
        import numpy as np
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.serve.trace import TraceRequest
        rng = np.random.default_rng(1)
        trace = [TraceRequest(0, rng.integers(0, cfg.vocab, 256)
                              .astype(np.int32), 16) for _ in range(8)]
        engine.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            summary = engine.run(trace)
            self.sync()
            wall = time.time() - t0
        rows = []
        for ev in prof.key_averages():
            if "CUDA" not in str(getattr(ev, "device_type", "")):
                continue                      # host-side op records
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            if dev_us > 0:
                rows.append((dev_us, ev.key, ev.count))
        rows.sort(reverse=True)
        busy_s = sum(r[0] for r in rows) / 1e6
        return self.record({
            "phase": "profile", "wall_s": wall, "device_busy_s": busy_s,
            "idle_share": 1 - busy_s / wall if wall > 0 else None,
            "prefills": summary["diagnostics"]["prefills"],
            "decode_rounds": summary["diagnostics"]["decode_rounds"],
            "top_kernels_ms": [[name[:80], round(us / 1e3, 3), n]
                               for us, name, n in rows[:15]]})


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="",
                    help="also write every result line to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    # f32 means f32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.time()
    logs = build.build_all()
    emit({"phase": "build", "kernels": sorted(logs),
          "source_dir": "src/repro_torch/kernels/csrc",
          "seconds": time.time() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in logs.items()}})

    smoke = Smoke(args)
    flash = [smoke.check_flash(s, torch.bfloat16) for s in (16, 100, 1024)]
    smoke.check_flash(100, torch.float32)
    smoke.check_flash(300, torch.float32, window=100)
    decode = [smoke.check_decode(sp) for sp in (1, 4)]
    smoke.check_model()
    smoke.run_serve()
    smoke.sync()

    def summary_row(name, rows, main, route_src, tpu):
        return {"name": name, "route": "cuda", "source": route_src,
                "replaces": tpu,
                "launches": smoke.serve_launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": main["library_ms"]}

    kernels = {"kernels": [
        summary_row("flash_fwd", flash, flash[-1], FLASH_SRC, FLASH_TPU),
        summary_row("flash_decode", decode, decode[-1], DECODE_SRC,
                    DECODE_TPU)]}
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"device": {"name": name, "smi": smi},
                                   "records": smoke.records, **kernels},
                                  indent=1))
    if smoke.failures:
        raise SystemExit("chip_smoke: failed checks:\n"
                         + "\n".join(smoke.failures))
    emit(kernels)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
