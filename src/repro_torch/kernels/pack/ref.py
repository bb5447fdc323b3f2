"""Plain PyTorch versions of the E-D codec kernels (counterpart of
``repro.kernels.pack.ref``), in the public image-major layout the CUDA
kernels write: image ``n`` is container ``n // 4``, byte lane ``n % 4``.

They run on the CPU and on the card (``int32`` views and ``int64``
packing, since PyTorch has no shifts for ``uint32``); the CPU tests and
``chip_smoke.py``'s comparison use them.  Bytes equal to 255 and
containers at or above 2^31 decode correctly.
"""
from __future__ import annotations

import torch

from repro_torch.core import encoding

LANES = encoding.PACK  # u8 images per u32 container


def decode_ref(packed: torch.Tensor, scale: float = 1.0 / 255.0,
               shift: float = 0.0) -> torch.Tensor:
    """uint32 (M, ...) -> float32 (4M, ...): each byte times ``scale`` plus
    ``shift``, rounded after the product and after the sum (float32)."""
    return encoding.unpack_u32_to_f32(packed, scale=scale, shift=shift)


def encode_ref(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (4M, ...) -> uint32 (M, ...)."""
    return encoding.pack_u8_to_u32(images_u8)
