#!/usr/bin/env python3
"""Where ``csrc/flash_decode.cu`` spends a launch, on one card.

    python3 tools/decode_phases.py [--parent OLD_flash_decode.cu] [--sass]
                                   [--out F]

Builds three instrumented copies of the decode kernel into
``build/decode_phases/`` (git-ignored; ``tools/variant_build.py``, one
``nvcc`` each, all started together):

* ``trace``: the kernel as it is, each warp's lane 0 keeping %globaltimer
  stamps in registers at its phases (entry, parameters read, barriers
  initialised, first copies issued, first block landed, loop done, CTA
  merged, state pushed, rank 0 done) and writing them out at its end;
* ``nocompute``: the same with the scores and values left out (the copies,
  the waits and the merges only): the memory side alone;
* ``nodata``: the same with 16-byte copies instead of the blocks (the
  compute runs on what the ring holds): the compute side alone;

and, with ``--parent``, the given older source as it is.  Then, at the
five decode shapes of ``chip_smoke.py`` and two extremes of llama's
(every row 1 token long, every row 2048), it times each kernel alone (CUDA
events, L2 flushed, median of 40), sweeps the cluster size C over 1-8
(overriding the kernel's choice through the environment of the
instrumented copies), prints the phase percentiles (0, 50, 90, 100, in us
from the first warp's entry) of one traced launch, and times an empty
cluster launch as the floor of the method.  With ``--sass`` it first
counts, with ``cuobjdump``, each instantiation's instructions and those of
its main loop (the longest conditional backward branch) by opcode.
Prints one JSON line each.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
from collections import Counter

import numpy as np

import variant_build

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

STAMPS = ["entry", "params", "inited", "issued", "q_loaded", "first_block",
          "loop_done", "cta_merged", "pushed", "rank0_done"]
HEADER = r'''
__device__ unsigned long long g_stamps[1 << 20];
static int g_last_cluster = 0;
__device__ __forceinline__ unsigned long long stamp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) stamps[k] = stamp_now()
#define STAMP_FLUSH() do { if (lane == 0) { \
  const size_t cid_ = (size_t)blockIdx.y * gridDim.x + blockIdx.x; \
  _Pragma("unroll") for (int k_ = 0; k_ < 10; ++k_) \
    g_stamps[(cid_ * NW + warp) * 10 + k_] = stamps[k_]; } } while (0)
__global__ void empty_kernel(int* p) { if (p) p[blockIdx.x] = 1; }
'''
FOOTER = r'''
extern "C" int stamps_read(void* dst, size_t n) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, n); }
extern "C" int stamps_zero() {
  static unsigned long long z[1 << 20];
  return (int)cudaMemcpyToSymbol(g_stamps, z, sizeof(z)); }
extern "C" int last_cluster() { return g_last_cluster; }
extern "C" int empty_launch(int C, int blocks, int smem, void* stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(128, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaFuncSetAttribute(empty_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int* none = nullptr;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, empty_kernel, none);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
'''
# (anchor in flash_decode.cu, text put before it, text put after it)
PROBES = [
    ("#include <stdint.h>\n", "", "#include <stdlib.h>\n"),
    ("namespace cg = cooperative_groups;\n", "", HEADER),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "", "  unsigned long long stamps[10] = {};\n  STAMP(0);\n"),
    ("  const int t0 = lo + blk0 * TB;\n", "", "  STAMP(1);\n"),
    ("    sm90::fence_barrier_init();\n", "", "    STAMP(2);\n"),
    ("    if (nb > 0) issue(0);\n  }\n", "", "  STAMP(3);\n"),
    ("  if (nb > 0) sm90::mbar_wait(&bar[0], 0);\n", "", "  STAMP(4);\n"),
    ("    sm90::mbar_wait(&bar[i % NS], (i / NS) & 1);\n", "",
     "    if (i == 0) STAMP(5);\n"),
    ("  // the warp's state into its drained ring", "  STAMP(6);\n", ""),
    ("  sm90::cluster_wait();  // rank 0", "  STAMP(7);\n", ""),
    ("  if (rank != 0) return;\n", "  STAMP(8);\n  STAMP_FLUSH();\n", ""),
    ("  if (a.counts != nullptr && hg == 0 && tid == 0)",
     "  STAMP(9);\n  STAMP_FLUSH();\n", ""),
    # the cluster size can be forced from the environment
    ("  const int C = cluster_size<GH, D>(units * a.nsp * groups, "
     "a.spt * a.bs);\n", "",
     "  const char* forced = getenv(\"DECODE_CLUSTER\");\n"
     "  const int C = forced != nullptr && atoi(forced) > 0 ? atoi(forced)"
     " : C_auto;\n  g_last_cluster = C;\n"),
]


def instrument(src: str) -> str:
    for anchor, before, after in PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"decode_phases: anchor not found once: "
                             f"{anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    src = src.replace("  const int C = cluster_size<GH, D>",
                      "  const int C_auto = cluster_size<GH, D>", 1)
    return src + FOOTER


def sass_loops(library: pathlib.Path) -> dict:
    """Instructions of each decode instantiation and of its main loop."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    at = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)")
    out = {}
    for chunk in text.split("Function : ")[1:]:
        kind = re.search(r"decode_kernelILi(\d+)ELi(\d+)E", chunk)
        if kind is None:
            continue
        code = [(int(m.group(1), 16), m.group(2), ln) for ln in
                chunk.splitlines() if (m := at.match(ln))]
        loop = (0, -1)
        for addr, _, ln in code:
            jump = re.search(r"@!?U?P\w+\s+BRA\s+0x([0-9a-f]+)", ln)
            if jump and int(jump.group(1), 16) < addr and \
                    addr - int(jump.group(1), 16) > loop[1] - loop[0]:
                loop = (int(jump.group(1), 16), addr)
        body = Counter(op for addr, op, _ in code
                       if loop[0] <= addr <= loop[1])
        out[f"GH={kind.group(1)},D={kind.group(2)}"] = {
            "instructions": len(code), "loop": sum(body.values()),
            "loop_mix": dict(body.most_common(8))}
    return out


def variants(src: str) -> dict[str, str]:
    traced = instrument(src)
    i0 = traced.index("    // partial scores:")
    i1 = traced.index("    __syncwarp();  // the stage and pw are free")
    copy = "    const uint32_t bytes = (uint32_t)min(TB, e - t) * D;"
    return {"trace": traced,
            "nocompute": traced[:i0] + traced[i1:],
            "nodata": traced.replace(copy,
                                     "    const uint32_t bytes = 16;", 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default="",
                    help="an older flash_decode.cu to time beside")
    ap.add_argument("--sass", action="store_true",
                    help="count the built library's instructions first")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    import chip_smoke
    from repro_torch.kernels import build, tiling
    from repro_torch.kernels.kvq import ops, ref
    from repro_torch.models import attention

    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    csrc = build.CSRC
    if args.sass:
        build.build_all(["flash_decode"])
        emit({"sass": sass_loops(build.library_path("flash_decode"))})
    srcs = variants((csrc / "flash_decode.cu").read_text())
    if args.parent:
        srcs["parent"] = pathlib.Path(args.parent).read_text()
    libs = {}
    for name, (lib, regs) in variant_build.build_variants(
            ROOT / "build" / "decode_phases",
            {name: {"flash_decode.cu": text} for name, text in srcs.items()},
            "flash_decode.cu", "decode_phases").items():
        for f in (lib.flash_decode, lib.flash_decode_bias):
            f.argtypes, f.restype = ops._ARGTYPES, ctypes.c_int
        libs[name] = lib
        emit({"lib": name, "registers": regs})

    dev = torch.device("cuda", 0)
    smoke = chip_smoke.Smoke(None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tr = libs["trace"]
    tr.empty_launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for c, blocks in ((1, 64), (8, 320)):
        emit({"empty_cluster_launch": {"C": c, "blocks": blocks},
              "ms": smoke.time_ms(lambda: tr.empty_launch(
                  c, blocks, 100000, stream), n=40)})

    llama = [1, 2048, 513, 512, 7, 1500, 1024, 64]
    shapes = {
        "llama_s1": (8, 8, 4, 128, 2048, 1, llama),
        "llama_s4": (8, 8, 4, 128, 2048, 4, llama),
        "hymba_band_s1": (8, 5, 5, 64, 2080, 1, 1024),
        "hymba_band_s4": (8, 5, 5, 64, 2080, 4, 1024),
        "hymba_len_s1": (8, 5, 5, 64, 2080, 1, [2079] * 8),
        "llama_len1_s1": (8, 8, 4, 128, 2048, 1, [1] * 8),
        "llama_full_s1": (8, 8, 4, 128, 2048, 1, [2048] * 8),
    }
    buf = (ctypes.c_ulonglong * (1 << 20))()
    for key, (b, hkv, g, d, s, sp, mask_arg) in shapes.items():
        gen = torch.Generator(device=dev).manual_seed(7)
        q = torch.randn((b, hkv, g, d), generator=gen, device=dev)
        kq, ks = ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=dev))
        vq, vs = ref.quantize_kv(torch.randn((b, hkv, s, d), generator=gen,
                                             device=dev))
        if isinstance(mask_arg, list):
            lengths = torch.tensor(mask_arg, dtype=torch.int32, device=dev)
            bias, mask = None, lengths
        else:
            lengths, bias = attention.decode_mask(
                torch.tensor(s - 2, dtype=torch.int32, device=dev), b, s,
                mask_arg)
            mask = bias
        want = ref.decode_attention_ref(q, kq, ks, vq, vs, bias, d ** -0.5,
                                        lengths=lengths)
        bs, ns, nsp, spt = tiling.resolve_decode_grid(s, splits=sp)
        o = torch.empty((b, hkv, nsp, g, d) if nsp > 1 else (b, hkv, g, d),
                        device=dev)
        m_p = torch.empty((b, hkv, nsp, g), device=dev)
        l_p = torch.empty_like(m_p)
        for name, lib in libs.items():
            f = lib.flash_decode if bias is None else lib.flash_decode_bias

            def call(f=f):
                err = f(q.data_ptr(), kq.data_ptr(), ks.data_ptr(),
                        vq.data_ptr(), vs.data_ptr(), mask.data_ptr(),
                        o.data_ptr(), m_p.data_ptr(), l_p.data_ptr(), None,
                        b, hkv, g, s, d, bs, ns, spt, nsp, d ** -0.5, stream)
                if err:
                    raise SystemExit(f"decode_phases: {name} failed: {err}")

            rec = {"shape": key, "lib": name,
                   "kernel_ms": smoke.time_ms(call, n=40)}
            if name != "parent":
                lib.last_cluster.restype = ctypes.c_int
                rec["C"] = lib.last_cluster()
                sweep = {}
                for c in range(1, 9):
                    os.environ["DECODE_CLUSTER"] = str(c)
                    call()
                    torch.cuda.synchronize()
                    got = o if nsp == 1 else ref.combine_splits(
                        o, m_p, l_p, torch.float32)
                    sweep[c] = {"ms": smoke.time_ms(call, n=40),
                                "err": float((got - want).abs().max())}
                os.environ.pop("DECODE_CLUSTER")
                rec["cluster_sweep"] = sweep
                lib.stamps_zero()
                torch.cuda.synchronize()
                smoke._flush_buf.zero_()
                call()
                torch.cuda.synchronize()
                lib.stamps_read(buf, ctypes.sizeof(buf))
                a = np.frombuffer(buf, dtype=np.uint64)[
                    :(1 << 20) // 10 * 10].reshape(-1, 10).astype(np.int64)
                a = a[a[:, 0] > 0]
                rel = (a - a[:, 0].min()) / 1e3
                for k, stamp in enumerate(STAMPS):
                    live = a[:, k] > 0
                    if live.any():
                        rec[stamp + "_us"] = [
                            round(float(np.percentile(rel[live, k], p)), 3)
                            for p in (0, 50, 90, 100)]
                rec["warps"] = int(len(a))
            emit(rec)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
