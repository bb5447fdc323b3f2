#!/usr/bin/env python3
"""What sets the pace of ``csrc/ssd_bwd_sm90.cu``, on one card.

    python3 tools/ssd_bwd_phases.py [--out F]

Builds copies of the tensor-core SSD chunk backward with parts of its work
taken out into ``build/ssd_bwd_phases/`` (git-ignored;
``tools/variant_build.py``, one ``nvcc`` each, all started together), and
times each as ``chip_smoke.py`` times a kernel (median of 20 launches, L2
flushed before each), in two rounds, at mamba2's and hymba's train shapes
(G=192 / 200, T=16, Q=128, N=128 / 16, P=64, 24 / 25 heads):

* ``full``: the kernel as it is;
* ``one_pass``: the hi hi pass only of each product (a third of the
  tensor-core work);
* ``no_products``: no product runs (no fragments, no wgmma): the copies,
  the splits, the elementwise work, the stores and the barriers;
* ``no_splits``: no operand is split into shared memory (the products
  read whatever the regions hold);
* ``no_elementwise``: the dM tiles' mask, decay, D and Z sums are skipped;
* ``copies_only``: no products, no splits, no elementwise work;
* ``one_group_U`` / ``_E`` / ``_dxbar`` / ``_dM``: that product cut to
  one group of k8 steps (its share of the time is full minus this).

The outputs of every variant but ``full`` are meaningless.  Each variant
is a text edit of the source, which fails loudly if the source no longer
holds the text it edits.  Prints one JSON line for each shape, with each
variant's ptxas registers.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import variant_build

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "ssd_bwd_phases"
SHAPES = [(192, 16, 128, 128, 64, 24), (200, 16, 128, 16, 64, 25)]
PASSES = ("    wgmma_tf32<NC>(acc, ah[s], bl, 1);\n"
          "    wgmma_tf32<NC>(acc, al[s], bh, 1);\n")
FIRST = ("  group(s_begin, ah0, al0);\n  fence_regs(acc);\n"
         "  issue_group<NC>(acc, ah0, al0, b_hi, b_lo, s_begin, R);\n"
         "  for (int s0 = s_begin + KC;")
EDITS = {
    "one_pass": [(PASSES, "")],
    "no_products": [(FIRST, "  for (int s0 = s_end;")],
    "no_splits": [("  for (int e = tid; e < R * k4; e += NT) {",
                   "  for (int e = tid; e < 0; e += NT) {"),
                  ("  for (int e = tid; e < R * (K / 4); e += NT) {",
                   "  for (int e = tid; e < 0; e += NT) {")],
    "no_elementwise": [("            if (jj <= ii) {",
                        "            if (jj < 0) {")],
    "one_group_U": [("sa + L::W1, sa + L::W1 + L::HALF, P, 0, N / 8);",
                     "sa + L::W1, sa + L::W1 + L::HALF, P, 0, KC);")],
    "one_group_E": [("sa + L::W0, sa + L::W0 + L::HALF, N, 0, P / 8);",
                     "sa + L::W0, sa + L::W0 + L::HALF, N, 0, KC);")],
    "one_group_dxbar": [("P, 8 * wg, QMAX / 8);",
                         "P, QMAX / 8 - KC, QMAX / 8);")],
    "one_group_dM": [("          QMAX, 0, P / 8);", "          QMAX, 0, KC);")],
}
VARIANTS = {
    "full": [], "one_pass": ["one_pass"], "no_products": ["no_products"],
    "no_splits": ["no_splits"], "no_elementwise": ["no_elementwise"],
    "copies_only": ["no_products", "no_splits", "no_elementwise"],
    **{f"one_group_{k}": [f"one_group_{k}"] for k in ("U", "E", "dxbar",
                                                       "dM")},
}


def build_variants(names) -> dict:
    """{name: (the variant's ``ssd_chunk_bwd_sm90``, ptxas registers)}."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ops
    src = (build.CSRC / "ssd_bwd_sm90.cu").read_text()
    sources = {name: {"ssd_bwd_sm90.cu": variant_build.edit(
        src, [e for n in VARIANTS[name] for e in EDITS[n]],
        "ssd_bwd_phases")} for name in names}
    libs = {}
    for name, (lib, regs) in variant_build.build_variants(
            OUT, sources, "ssd_bwd_sm90.cu", "ssd_bwd_phases").items():
        fn = lib.ssd_chunk_bwd_sm90
        fn.argtypes, fn.restype = ops.KERNEL_BWD_SM90.argtypes, ctypes.c_int
        libs[name] = (fn, regs)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    dev = torch.device("cuda", 0)
    smoke = chip_smoke.Smoke(None)
    libs = build_variants(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    rows = []
    for g, t, q, n, p, h in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                     device=dev)
        ins = [rnd(g // h, t, q, n), rnd(g // h, t, q, n), rnd(g, t, q, p),
               torch.cumsum(-0.2 * torch.rand((g, t, q), generator=gen,
                                              device=dev), -1),
               rnd(g, t, q, p), rnd(g, t, n, p)]
        outs = [torch.empty_like(ins[2]), torch.empty_like(ins[3]),
                torch.empty_like(ins[0]), torch.empty_like(ins[1])]
        ptrs = [z.data_ptr() for z in ins + outs]

        def call(fn):
            err = fn(*ptrs, g, t, q, n, p, h,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"ssd_bwd_phases: launch failed ({err})")

        row = {"phase": "ssd_bwd_phases", "nvidia_smi": smi,
               "shape": {"G": g, "T": t, "Q": q, "N": n, "P": p, "heads": h},
               "registers": {k: v[1] for k, v in libs.items()}, "ms": {}}
        for _ in range(2):
            for name, (fn, _) in libs.items():
                row["ms"].setdefault(name, []).append(
                    smoke.time_ms(lambda: call(fn), n=20))
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
