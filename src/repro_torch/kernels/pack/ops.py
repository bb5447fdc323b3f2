"""Public E-D codec ops (counterpart of ``repro.kernels.pack.ops``).

``decode(packed)`` is the network's input layer, the paper's "custom deep
learning layer to decode each input matrix": uint32 (M, ...) -> float32
(4M, ...), image ``n`` from container ``n // 4``, byte lane ``n % 4``.
``encode`` is its inverse on uint8 images.  Both dispatch on the tensor's
device: a CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
goes to the hand-written kernels of ``kernels/csrc/pack.cu``, or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.pack import ref
from repro_torch.kernels.pack.ref import LANES

DECODE = build.Kernel("pack", "pack_decode", [
    build.PTR, build.PTR, build.INT, build.INT, build.FLOAT, build.FLOAT,
    build.PTR])
ENCODE = build.Kernel("pack", "pack_encode", [
    build.PTR, build.PTR, build.INT, build.INT, build.PTR])
_INT_MAX = 2 ** 31 - 1


def _check_cuda(x: torch.Tensor, name: str, m: int, p: int) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous tensor")
    if m < 1 or p < 1 or m > _INT_MAX or p > _INT_MAX:
        raise ValueError(f"{name}: the CUDA kernel takes 1 <= containers, "
                         f"pixels per container < 2^31; got {m}, {p}")


def decode(packed: torch.Tensor, *, scale: float = 1.0 / 255.0,
           shift: float = 0.0) -> torch.Tensor:
    """uint32 (M, ...) -> float32 (4M, ...): unpack + normalise."""
    if packed.dtype != torch.uint32:
        raise TypeError(f"decode expects uint32, got {packed.dtype}")
    if not packed.is_cuda:
        return ref.decode_ref(packed, scale, shift)
    m, rest = packed.shape[0], tuple(packed.shape[1:])
    p = math.prod(rest)
    _check_cuda(packed, "decode", m, p)
    out = torch.empty((LANES * m,) + rest, dtype=torch.float32,
                      device=packed.device)
    DECODE(packed.data_ptr(), out.data_ptr(), m, p, float(scale),
           float(shift), torch.cuda.current_stream(packed.device).cuda_stream)
    return out


def encode(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (N, ...) with N % 4 == 0 -> uint32 (N // 4, ...)."""
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"encode expects uint8, got {images_u8.dtype}")
    n, rest = images_u8.shape[0], tuple(images_u8.shape[1:])
    if n % LANES:
        raise ValueError(f"encode: N={n} is not a multiple of {LANES}")
    if not images_u8.is_cuda:
        return ref.encode_ref(images_u8)
    m, p = n // LANES, math.prod(rest)
    _check_cuda(images_u8, "encode", m, p)
    out = torch.empty((m,) + rest, dtype=torch.uint32,
                      device=images_u8.device)
    ENCODE(images_u8.data_ptr(), out.data_ptr(), m, p,
           torch.cuda.current_stream(images_u8.device).cuda_stream)
    return out
