#!/usr/bin/env python3
"""Run ``chip_smoke.py`` phases from two trees of this repository on one
card, in the order A, B, B, A, each run in its own process from its tree's
root (so each tree builds and imports its own kernels), and print every
result line tagged with its tree and turn.

    python3 tools/compare_trees.py OLD_ROOT NEW_ROOT \
        [--phases decode,ssd,ssd_bwd,serve_ssm,serve,train,train_ssm]
        [--out FILE]

OLD_ROOT is typically the parent commit unpacked with ``git archive`` into
a git-ignored directory (``build/parent``).  Phases (``Smoke`` methods):

* ``decode``: the five timed decode kernel lines (llama's shape at splits
  1 and 4, hymba's window band at splits 1 and 4, hymba's G=5 lengths);
* ``ssd``: the four SSD chunk kernel lines (mamba2's and hymba's serve
  shapes, a 64-token prompt, a single chunk);
* ``ssd_bwd``: the three SSD chunk backward kernel lines every tree has
  (mamba2's and hymba's train shapes, the smoke configs' widths), each on
  the tree's own route;
* ``serve_ssm``: the mamba2-130m and hymba-1.5b lockstep serve runs and
  their profiles;
* ``serve``: the llama3-8b engine run and its profile;
* ``train``: the 4-layer llama3-8b train steps and their profile;
* ``train_ssm``: the full-size mamba2-130m and hymba-1.5b train steps,
  their profiles and their remat-off / remat-on memory;
* ``ssm_greedy``: hymba-1.5b's lockstep greedy tokens (batch 8 x 32) with
  the decode kernel and with its plain PyTorch version on the card, and
  the first step at which each row's two token streams differ.

Needs a CUDA card; exits non-zero if any run fails.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

DRIVER = """
import argparse
import sys
sys.path.insert(0, ".")
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
import json
import numpy as np


def greedy(s):
    # hymba-1.5b's lockstep greedy tokens (batch 8 x 32) with the decode
    # kernel, then with its plain PyTorch version on the card
    from repro_torch import configs
    from repro_torch.kernels.kvq import ops, ref
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(
        ["--arch", "hymba-1.5b", "--batch", str(chip_smoke.SSM_BATCH),
         "--prompt-len", str(chip_smoke.SSM_PROMPT),
         "--gen", str(chip_smoke.SSM_GEN), "--policy", "bf16", "--seed", "0"])
    cfg = configs.get_config("hymba-1.5b")
    model = serve.build_model(args, cfg, s.dev)
    kernel = ops.decode_attention

    def plain(q, k_q, k_s, v_q, v_s, *, lengths=None, bias=None,
              sm_scale=None, splits=1, block_s=None, counts=False):
        b, h, d = q.shape
        hkv = k_q.shape[1]
        sm = float(sm_scale) if sm_scale is not None else d ** -0.5
        return ref.decode_attention_ref(
            q.float().reshape(b, hkv, h // hkv, d), k_q, k_s, v_q, v_s,
            bias, sm, lengths=lengths).reshape(b, h, d)

    toks = {}
    for name, fn in (("kernel", kernel), ("plain", plain)):
        ops.decode_attention = fn
        toks[name] = serve.lockstep(args, cfg, model, s.dev)["tokens"]
    ops.decode_attention = kernel
    same = toks["kernel"] == toks["plain"]
    first = [int(np.argmin(row)) if not row.all() else None for row in same]
    print(json.dumps({"phase": "ssm_greedy", "arch": "hymba-1.5b",
                      "first_step_kernel_differs_from_plain": first,
                      "kernel_tokens": toks["kernel"].tolist(),
                      "plain_tokens": toks["plain"].tolist()}), flush=True)


s = chip_smoke.Smoke(argparse.Namespace(seed=0, out=""))
for phase in PHASES:
    if phase == "decode":
        s.check_decode(1)
        s.check_decode(4)
        s.check_decode_hymba(1, bias=True)
        s.check_decode_hymba(4, bias=True)
        s.check_decode_hymba(1, bias=False)
    elif phase == "ssd":
        s.check_ssd(192, 16, 128, 128, 64, 24)
        s.check_ssd(200, 16, 128, 16, 64, 25)
        s.check_ssd(192, 1, 64, 128, 64, 24)
        s.check_ssd(192, 1, 128, 128, 64, 24)
    elif phase == "ssd_bwd":
        s.check_ssd_bwd(192, 16, 128, 128, 64, 24)
        s.check_ssd_bwd(200, 16, 128, 16, 64, 25)
        s.check_ssd_bwd(8, 2, 32, 16, 16, 4)
    elif phase == "serve_ssm":
        s.run_serve_ssm()
    elif phase == "serve":
        s.run_serve()
    elif phase == "train":
        s.run_train()
    elif phase == "train_ssm":
        s.run_train_ssm()
    elif phase == "ssm_greedy":
        greedy(s)
    else:
        raise SystemExit(f"unknown phase {phase}")
"""


def run(root: pathlib.Path, phases: list[str]) -> list[dict]:
    proc = subprocess.run([sys.executable, "-c",
                           DRIVER.replace("PHASES", repr(phases))],
                          cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"compare_trees: the run in {root} failed "
                         f"(exit {proc.returncode})")
    rows = []
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            rows.append(json.loads(line))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_root")
    ap.add_argument("new_root")
    ap.add_argument("--phases", default="decode")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    trees = {"A": pathlib.Path(args.old_root).resolve(),
             "B": pathlib.Path(args.new_root).resolve()}
    results = []
    for turn, tree in enumerate("ABBA"):
        for row in run(trees[tree], phases):
            row = {"tree": tree, "turn": turn, **row}
            results.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
