"""The device an entry point runs on: the card unless the caller asks for
the CPU, and no quiet fallback when there is no card."""
from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; for CUDA, raise without a card and turn TF32
    off (the f32 policy must mean f32 on the card too)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass --device cpu "
                               "to run the plain PyTorch versions")
        # f32 matmuls and convolutions in full f32, not TF32 (three decimal
        # digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
