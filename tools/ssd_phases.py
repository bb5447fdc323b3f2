#!/usr/bin/env python3
"""What sets the pace of ``csrc/ssd_sm90.cu``, on one card.

    python3 tools/ssd_phases.py [--out F]

Builds copies of the tensor-core SSD chunk kernel with parts of its work
taken out into ``build/ssd_phases/`` (git-ignored; ``tools/variant_build.py``,
one ``nvcc`` each, all started together), and times each as
``chip_smoke.py`` times a kernel (median of 20 launches, L2 flushed before
each), in two rounds, at mamba2's and hymba's serve shapes (G=192 / 200,
T=16, Q=128, N=128 / 16, P=64, 24 / 25 heads, every head in one CTA):

* ``full``: the kernel as it is;
* ``no_transpose``: x_bar is not transposed and split into x^T hi / lo
  (the products read what x^T holds);
* ``no_stores``: y and the state are not stored;
* ``const_frags``: the A fragments are constants (no reads of S, B, da,
  w, no decay, mask or split): the products without their arithmetic;
* ``one_pass``: the hi hi pass only of each product (a third of the
  tensor-core work);
* ``cvt_round``: tf32 rounding by ``cvt.rna.tf32.f32`` instead of the
  integer add and mask (the same bits; checked against ``full``);
* ``products_only``: no transpose, no stores, constant fragments;
* ``copies_transpose_only``: no products (the copies, the score product,
  the transposes and the barriers);
* ``copies_only``: no products and no transpose.

The inputs are >= 50 MB, past the L2.  Each variant is a text edit of the
source, which fails loudly if the source no longer holds the text it
edits.  Prints one JSON line for each shape, with each variant's ptxas
registers.  Needs a CUDA card and nvcc.
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

OUT = ROOT / "build" / "ssd_phases"
SHAPES = [(192, 16, 128, 128, 64, 24), (200, 16, 128, 16, 64, 25)]
PASSES = ("      wgmma_tf32<NC>(acc, ah[s], bl, 1);\n"
          "      wgmma_tf32<NC>(acc, al[s], bh, 1);\n")
CONST = "ah[s][k] = al[s][k] = 0x3f800000u + k;"
EDITS = {
    "no_transpose": [("      if (e >= qk / 4 * P) break;",
                      "      if (e >= 0) break;")],
    "no_stores": [("      if (!Y || row < Q)\n", "      if (row < 0)\n"),
                  ("      sp[(size_t)n * P + r0",
                   "      if (n < 0) sp[(size_t)n * P + r0")],
    "const_frags": [
        ("      split_tf32(g, ah[s][k], al[s][k]);", "      " + CONST),
        ("        split_tf32(bvv[k] * w[k / 2], ah[s][k], al[s][k]);",
         "        " + CONST),
        ("        split_tf32(xv * w_s[j], ah[s][k], al[s][k]);",
         "        " + CONST)],
    "one_pass": [(PASSES, "")],
    "no_products": [
        ("    if (wg == 0)\n      head_products",
         "    if (false)\n      head_products"),
        ("    else if (wg == 1 && Q > 64)\n      head_products",
         "    else if (false)\n      head_products"),
        ("    else if (wg == 2)\n      head_products",
         "    else if (false)\n      head_products"),
        ("      if (wg == 3)\n        head_products",
         "      if (false)\n        head_products")],
}
HEADER_EDITS = {
    "cvt_round": [("  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
                   '''  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r;''')],
}
VARIANTS = {
    "full": [], "no_transpose": ["no_transpose"], "no_stores": ["no_stores"],
    "const_frags": ["const_frags"], "one_pass": ["one_pass"],
    "cvt_round": ["cvt_round"],
    "products_only": ["no_transpose", "no_stores", "const_frags"],
    "copies_transpose_only": ["no_products"],
    "copies_only": ["no_products", "no_transpose"],
}


def build_variants(names) -> dict:
    """{name: (the variant's ``ssd_chunk_sm90``, ptxas registers)}."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ops
    src = (build.CSRC / "ssd_sm90.cu").read_text()
    hdr = (build.CSRC / "sm90.cuh").read_text()
    sources = {}
    for name in names:
        edits = VARIANTS[name]
        # the .cu includes "sm90.cuh" from its own directory first
        sources[name] = {
            "sm90.cuh": variant_build.edit(hdr, [
                e for n in edits for e in HEADER_EDITS.get(n, [])],
                "ssd_phases"),
            "ssd_sm90.cu": variant_build.edit(src, [
                e for n in edits for e in EDITS.get(n, [])], "ssd_phases")}
    libs = {}
    for name, (lib, regs) in variant_build.build_variants(
            OUT, sources, "ssd_sm90.cu", "ssd_phases").items():
        fn = lib.ssd_chunk_sm90
        fn.argtypes, fn.restype = ops.KERNEL_SM90.argtypes, ctypes.c_int
        libs[name] = (fn, regs)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssd_phases: no CUDA device", file=sys.stderr)
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
        c = torch.randn((g // h, t, q, n), generator=gen, device=dev)
        b = torch.randn((g // h, t, q, n), generator=gen, device=dev)
        x = torch.randn((g, t, q, p), generator=gen, device=dev)
        acum = torch.cumsum(-0.2 * torch.rand((g, t, q), generator=gen,
                                              device=dev), -1)
        outs = {}

        def call(fn, y, st):
            err = fn(c.data_ptr(), b.data_ptr(), x.data_ptr(),
                     acum.data_ptr(), y.data_ptr(), st.data_ptr(), g, t, q,
                     n, p, h, h, torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"ssd_phases: launch failed ({err})")

        for name in ("full", "cvt_round"):
            y = torch.zeros_like(x)
            st = torch.zeros((g, t, n, p), device=dev)
            call(libs[name][0], y, st)
            outs[name] = (y, st)
        row = {"phase": "ssd_phases", "nvidia_smi": smi,
               "shape": {"G": g, "T": t, "Q": q, "N": n, "P": p, "heads": h},
               "cvt_round_equals_full": all(
                   torch.equal(a, b) for a, b in zip(outs["full"],
                                                     outs["cvt_round"])),
               "registers": {k: v[1] for k, v in libs.items()}, "ms": {}}
        y = torch.empty_like(x)
        st = torch.empty((g, t, n, p), device=dev)
        for _ in range(2):
            for name, (fn, _) in libs.items():
                row["ms"].setdefault(name, []).append(
                    smoke.time_ms(lambda: call(fn, y, st), n=20))
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
