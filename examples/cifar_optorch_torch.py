"""Paper-faithful end-to-end driver on PyTorch (the port of
``examples/cifar_optorch.py``): ResNet-18 on CIFAR-shaped data with the
full OpTorch pipeline -- Parallel E-D (a background thread encodes uint8
images into uint32 containers on the host; the first layer decodes them on
the device with the hand-written CUDA kernel), Selective-batch-sampling,
Sequential checkpoints placed by the planner, and Mixed precision.

Reproduces the paper's Fig. 9 claim at reduced scale: the optimised
pipelines reach the SAME accuracy as the standard pipeline.

    python examples/cifar_optorch_torch.py [--steps 100] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` asks for the CPU (where
the decode layer is the kernel's plain PyTorch version); with no card and
no ``--device cpu`` it exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import plan as plan_mod  # noqa: E402
from repro_torch.core.checkpoint import CheckpointConfig  # noqa: E402
from repro_torch.data.pipeline import ParallelEncodedLoader  # noqa: E402
from repro_torch.data.synthetic import make_cifar_like  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

PIPELINES = ("baseline", "ED", "ED+SC", "ED+SC+MP")
BATCH = 32
NUM_CHECKPOINTS = 5


@dataclasses.dataclass
class TrainResult:
    pipeline: str
    seconds: float          # wall time of the whole run, loader included
    acc: float              # mean accuracy of the last 20 steps
    losses: list            # every step's loss (before its update)
    accs: list              # every step's batch accuracy
    step_s: list            # host clock around each step, ending in a sync
    plan: plan_mod.RematPlan | None
    peak_bytes: int | None  # max_memory_allocated over the run (card only)


def pipeline_flags(pipeline: str) -> tuple[bool, bool, bool]:
    """(E-D, S-C, MP) of a pipeline name such as ``"ED+SC+MP"``."""
    parts = set(pipeline.split("+"))
    return "ED" in parts, "SC" in parts, "MP" in parts


def make_step(cfg: cnn.ResNetConfig, ocfg: adamw.AdamWConfig, *,
              use_ed: bool, use_mp: bool, remat=None):
    """One training step: loss and gradients in the pipeline's precision
    (MP casts the f32 master parameters to bf16 inside the step, and the
    gradients come back in f32), then AdamW on the f32 masters in place."""
    def step(params, opt, im, lb):
        p = {n: v.to(torch.bfloat16) for n, v in params.items()} \
            if use_mp else params
        loss, aux = cnn.loss_fn(p, cfg, im, lb, remat=remat, decode=use_ed)
        grads = torch.autograd.grad(loss, list(params.values()))
        g = {n: gi.float() for n, gi in zip(params, grads)}
        adamw.update(ocfg, g, opt, params)
        return loss.detach(), aux["acc"]
    return step


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch -> ``device``: through pinned memory, asynchronously,
    when ``device`` is a card."""
    t = torch.from_numpy(x)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def train(pipeline: str, imgs, labels, steps: int, seed=0, *,
          device="cuda", cfg: cnn.ResNetConfig | None = None,
          params: dict | None = None, log_every: int = 50) -> TrainResult:
    """Train ``cfg`` (default ResNet-18) for ``steps`` steps of ``pipeline``
    on batches of 32 from the E-D loader (SBS doubling class 0).
    ``params`` (f32 {name: tensor} on ``device``) replaces the random init
    from ``seed``; it is updated in place."""
    device = torch.device(device)
    cfg = cfg or cnn.resnet18()
    if params is None:
        params = cnn.init_params(cfg, seed, device=device)
    params = {n: p.requires_grad_() for n, p in params.items()}
    opt = adamw.init(params)
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps,
                             weight_decay=0.0)
    use_ed, use_sc, use_mp = pipeline_flags(pipeline)
    codec = "u32" if use_ed else "none"
    remat, plan = None, None
    if use_sc:
        # profile-driven S-C: walk the layer chain on meta tensors and put
        # the checkpoints at the byte-optimal sites (paper Fig. 11)
        image = torch.empty((BATCH,) + tuple(imgs.shape[1:]), device="meta")
        plan = plan_mod.plan_min_peak(
            plan_mod.profile_resnet(params, cfg, image), NUM_CHECKPOINTS)
        remat = CheckpointConfig(plan=plan)
    step = make_step(cfg, ocfg, use_ed=use_ed, use_mp=use_mp, remat=remat)

    # SBS: oversample class 0 2x (paper II.A.1) to show batch control
    weights = {c: (2.0 if c == 0 else 1.0) for c in range(10)}
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    losses, accs, step_s = [], [], []
    with ParallelEncodedLoader(imgs, labels, BATCH, codec=codec,
                               class_weights=weights, prefetch=4) as dl:
        for i in range(steps):
            enc, lb = next(dl)
            t = time.time()
            loss, acc = step(params, opt, to_device(enc, device),
                             to_device(lb, device))
            losses.append(float(loss))          # syncs the step
            accs.append(float(acc))
            step_s.append(time.time() - t)
            if log_every and i % log_every == 0:
                print(f"  [{pipeline}] step {i:4d} "
                      f"loss {losses[-1]:.3f} acc {accs[-1]:.3f}",
                      flush=True)
    seconds = time.time() - t0
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    return TrainResult(pipeline, seconds, float(np.mean(accs[-20:])),
                       losses, accs, step_s, plan, peak)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("cifar_optorch_torch: no CUDA device (use --device cpu)",
              file=sys.stderr)
        return 1
    imgs, labels = make_cifar_like(n=2048, seed=0)

    print("pipeline       time(s)  final-acc   (paper Fig. 9 analogue)")
    results = {}
    for pipe in PIPELINES:
        r = train(pipe, imgs, labels, args.steps, device=args.device)
        results[pipe] = r
        print(f"{pipe:13s} {r.seconds:7.1f}  {r.acc:9.3f}", flush=True)

    base_acc = results["baseline"].acc
    for pipe, r in results.items():
        if not r.acc > base_acc - 0.1:
            print(f"{pipe} accuracy regressed vs baseline ({r.acc} vs "
                  f"{base_acc})", file=sys.stderr)
            return 1
    print("\nAll optimized pipelines within 0.1 accuracy of baseline -- the "
          "paper's parity claim reproduces.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
