"""Quickstart on PyTorch (the port of ``examples/quickstart.py``):
OpTorch-style one-line optimization wrappers, composing the paper's three
pipelines on a small model, with the memory and parity story in under a
minute:

    python examples/quickstart_torch.py [--device cpu]

Memory is the bytes autograd keeps from the forward for the backward
(``torch.autograd.graph.saved_tensors_hooks``: every saved tensor counted
once, the weights it saves included), where the JAX original reads XLA's
temp buffer size; on the card the peak above the weights is printed
beside.  It runs on the CUDA card unless ``--device cpu`` asks for the
CPU (the kernels' plain PyTorch versions); with no card and no ``--device
cpu`` it exits non-zero.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import mp, sc, sc_mp  # noqa: E402  (the paper's API)
from repro_torch.core.checkpoint import CheckpointConfig  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.core.mixed_precision import get_policy  # noqa: E402
from repro_torch.models import transformer  # noqa: E402


def saved_mb(loss_fn) -> float:
    """MiB of the tensors autograd saves while ``loss_fn()`` runs its
    forward (each storage once)."""
    seen = {}

    def pack(t):
        seen[(t.untyped_storage().data_ptr(), t.device)] = \
            t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = loss_fn()
    loss.backward()
    return sum(seen.values()) / 2 ** 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs.smoke_config("llama3-8b")
    model = transformer.init_params(cfg, 0, device=dev).requires_grad_()
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.seq)).astype(np.int32)).to(dev)
        for k in ("tokens", "labels")}

    def loss(remat, policy):
        return lambda: transformer.loss_fn(
            model, cfg, batch, policy=get_policy(policy),
            remat=CheckpointConfig(enabled=remat))[0]

    print("pipeline            saved-MB   (paper Fig. 10 analogue)")
    for name, remat, pol in [("standard (B)", False, "full"),
                             ("M-P", False, "bf16"),
                             ("S-C", True, "full"),
                             ("S-C + M-P", True, "bf16")]:
        peak = ""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        mb = saved_mb(loss(remat, pol))
        if dev.type == "cuda":
            above = torch.cuda.max_memory_allocated(dev) - base
            peak = f"  peak {above / 2 ** 20:8.1f} MiB"
        model.zero_grad(set_to_none=True)
        print(f"{name:18s} {mb:8.1f}{peak}")

    # numerical parity: S-C is exact, the paper's 'same accuracy' claim
    with torch.no_grad():
        l_std = float(loss(False, "full")())
        l_sc = float(loss(True, "full")())
    print(f"\nloss standard={l_std:.6f}  S-C={l_sc:.6f} "
          f"(identical: {abs(l_std - l_sc) < 1e-5})")

    # one-line wrappers, as the paper advertises (`scmodel = sc(model)`):
    # an apply function of (weights, batch), the weights a dict
    def fwd(weights, b):
        return transformer.forward(model, cfg, b)[0] if weights is None \
            else torch.func.functional_call(
                _Apply(model, cfg), weights, (b,))

    weights = {f"model.{n}": p for n, p in model.named_parameters()}
    scmodel = sc(fwd)           # noqa: F841
    mpmodel = mp(fwd, policy="bf16")  # noqa: F841
    both = sc_mp(fwd)
    out = both(weights, batch)
    print(f"sc_mp(model) logits: {tuple(out.shape)} {out.dtype}")
    return 0


class _Apply(torch.nn.Module):
    """The model as a module whose ``forward`` is ``transformer.forward``,
    so ``torch.func.functional_call`` can swap its weights."""

    def __init__(self, model, cfg):
        super().__init__()
        self.model, self.cfg = model, cfg

    def forward(self, batch):
        return transformer.forward(self.model, self.cfg, batch)[0]


if __name__ == "__main__":
    raise SystemExit(main())
