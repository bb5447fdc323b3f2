"""End-to-end LM training driver on PyTorch (the port of
``examples/train_llm.py``): a ~100M-param llama-style model with the full
production stack (S-C remat, bf16 M-P, gradient accumulation, AdamW,
atomic checkpointing + resume, preemption handling, step watchdog),
through ``repro_torch.launch.train``.

``--tiny`` is a CPU-sized variant; drop it on the card to train the full
~100M config for a few hundred steps:

    python examples/train_llm_torch.py [--tiny] [--steps 300] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` asks for the CPU (the
kernels' plain PyTorch versions); with no card and no ``--device cpu`` it
exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402


def model_100m() -> ModelConfig:
    # ~115M params: 12L x 768, GQA 12/4 heads, vocab 32k
    return ModelConfig(arch_id="llama-100m", family="dense", n_layers=12,
                       d_model=768, n_heads=12, n_kv=4, d_ff=2048,
                       vocab=32000)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-sized variant of the 100M config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default="train_llm_ckpt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu")
    args = ap.parse_args(argv)

    cfg = model_100m()
    if args.tiny:
        cfg = dataclasses.replace(cfg, n_layers=4, d_model=128, n_heads=4,
                                  n_kv=2, d_ff=256, vocab=2048)

    # register the config so the production launcher can resolve it
    orig = configs.get_config
    configs.get_config = lambda a, _o=orig: cfg if a == cfg.arch_id \
        else _o(a)
    try:
        return launch_train.main([
            "--arch", cfg.arch_id, "--device", args.device,
            "--steps", str(args.steps), "--batch", "8",
            "--seq", "128" if args.tiny else "256", "--accum", "2",
            "--policy", "bf16", "--ckpt-dir", args.ckpt_dir,
            "--ckpt-every", "100", "--log-every", "20"])
    finally:
        configs.get_config = orig


if __name__ == "__main__":
    raise SystemExit(main())
