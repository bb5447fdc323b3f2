"""Encoding-Decoding (E-D), OpTorch's data-flow optimisation (counterpart
of ``repro.core.encoding``; the numpy paths are copies of the JAX
package's and give the same bytes).

Three codecs:

1. ``encode_base256`` / ``decode_base256``: paper Algorithms 1 and 3, the
   same positional pixel of N uint8 images packed into one float64 value
   sum_i 256^i * M[i]; exact for N <= 6 in float64.  Host-side numpy.
2. ``encode_lossless`` / ``decode_lossless``: paper Algorithm 4, base-128
   packing plus a 1-bit parity plane per image.  Host-side numpy.
3. ``pack_u8_to_u32`` / ``unpack_u32_to_u8``: 4 uint8 pixels per uint32
   container, bit-exact for any N.  The codec the pipeline deploys, and
   the layout the decode kernel (``repro_torch.kernels.pack``) consumes.
   On numpy arrays it is numpy; on ``torch.Tensor`` it is torch.

Plus Selective-batch-sampling (SBS, Algorithm 2): class-weighted batch
composition with per-class pre-processing hooks.

PyTorch has no ``>>`` or ``<<`` for ``torch.uint32``, so the torch paths
shift an ``int32`` view (an arithmetic shift of a negative value followed
by ``& 0xFF`` still gives the right byte) or pack in ``int64`` and
reinterpret the low 32 bits.
"""
from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Paper Algorithm 1 & 3: positional base-256 packing (host-side, float64).
# ---------------------------------------------------------------------------
MAX_BASE256_F64 = 6   # 256^7 > 2^53: float64 mantissa limit for exactness
MAX_BASE256_I64 = 7   # 256^8 overflows signed int64


def encode_base256(batch: np.ndarray, *, dtype=np.float64) -> np.ndarray:
    """Paper Algorithm 1: A = sum_i 256^i * X[i].

    batch: uint8 array (N, H, W, C) with N <= capacity of ``dtype``.
    Returns an (H, W, C) container of ``dtype``.
    """
    batch = np.asarray(batch)
    if batch.dtype != np.uint8:
        raise TypeError("base-256 codec packs uint8 images")
    n = batch.shape[0]
    cap = MAX_BASE256_F64 if dtype == np.float64 else MAX_BASE256_I64
    if n > cap:
        raise ValueError(f"{n} images exceed exact capacity {cap} of {dtype}")
    acc = np.zeros(batch.shape[1:], dtype=dtype)
    for i in range(n):
        acc = acc + batch[i].astype(dtype) * (dtype(256) ** i)
    return acc


def decode_base256(container: np.ndarray, n: int) -> np.ndarray:
    """Paper Algorithm 3: X[i] = A mod 256; A = A div 256 (integer div)."""
    a = np.asarray(container).astype(np.int64)
    out = np.empty((n,) + a.shape, dtype=np.uint8)
    for i in range(n):
        out[i] = (a % 256).astype(np.uint8)
        a = a // 256
    return out


# ---------------------------------------------------------------------------
# Paper Algorithm 4: loss-less forced encoding (base-128 + offset plane).
# ---------------------------------------------------------------------------
def encode_lossless(batch: np.ndarray, *, dtype=np.float64):
    """Base-128 packing with a parity-offset bit plane.

    Returns (container, offsets) where offsets is a bool plane
    (N, H, W, C).  Halving the per-image domain to 0..127 doubles capacity.
    """
    batch = np.asarray(batch)
    if batch.dtype != np.uint8:
        raise TypeError("lossless codec packs uint8 images")
    n = batch.shape[0]
    cap = 7 if dtype == np.float64 else 9  # 128^8 > 2^53; 128^9 < 2^63
    if n > cap:
        raise ValueError(f"{n} images exceed exact capacity {cap} of {dtype}")
    acc = np.zeros(batch.shape[1:], dtype=dtype)
    offsets = np.empty((n,) + batch.shape[1:], dtype=bool)
    for i in range(n):
        img = batch[i]
        offsets[i] = (img % 2).astype(bool)   # the parity offset
        half = (img // 2).astype(dtype)       # domain 0..127
        acc = acc + half * (dtype(128) ** i)
    return acc, offsets


def decode_lossless(container: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    a = np.asarray(container).astype(np.int64)
    n = offsets.shape[0]
    out = np.empty_like(offsets, dtype=np.uint8)
    for i in range(n):
        half = (a % 128).astype(np.uint8)
        out[i] = half * 2 + offsets[i].astype(np.uint8)
        a = a // 128
    return out


# ---------------------------------------------------------------------------
# The deployed codec: 4x uint8 -> uint32 bit packing (always exact).
# ---------------------------------------------------------------------------
PACK = 4  # u8 lanes per u32 container


def _shifts(ndim: int, like):
    """(1, 4, 1, ...) lane shifts 0, 8, 16, 24 in ``like``'s dtype (and on
    its device)."""
    if isinstance(like, torch.Tensor):
        s = torch.arange(PACK, dtype=like.dtype, device=like.device) * 8
    else:
        s = np.arange(PACK, dtype=like.dtype) * 8
    return s.reshape((1, PACK) + (1,) * (ndim - 1))


def pack_u8_to_u32(batch: np.ndarray | torch.Tensor):
    """Pack groups of 4 images into uint32 containers.

    batch: uint8 (N, ...) with N % 4 == 0  ->  uint32 (N//4, ...).
    Grouping is along the leading axis: container j holds images
    4j..4j+3 at byte lanes 0..3.  Works on numpy arrays or tensors.
    """
    n = batch.shape[0]
    if n % PACK:
        raise ValueError(f"N={n} not a multiple of {PACK}")
    grouped = (n // PACK, PACK) + tuple(batch.shape[1:])
    if isinstance(batch, torch.Tensor):
        x = batch.to(torch.int64).reshape(grouped)
        words = (x << _shifts(batch.ndim, x)).sum(1)
        # the low 32 bits, reinterpreted: wrap to int32 range, then view
        words = words - (words >= 2 ** 31).to(torch.int64) * 2 ** 32
        return words.to(torch.int32).view(torch.uint32)
    x = batch.astype(np.uint32).reshape(grouped)
    return (x << _shifts(batch.ndim, x)).sum(axis=1).astype(np.uint32)


def unpack_u32_to_u8(packed: np.ndarray | torch.Tensor):
    """Inverse of :func:`pack_u8_to_u32` -> uint8 (4*M, ...)."""
    m = packed.shape[0]
    flat = (m * PACK,) + tuple(packed.shape[1:])
    if isinstance(packed, torch.Tensor):
        words = packed.view(torch.int32)[:, None]
        vals = (words >> _shifts(packed.ndim, words)) & 0xFF
        return vals.to(torch.uint8).reshape(flat)
    vals = (packed[:, None] >> _shifts(packed.ndim, packed)) \
        & np.uint32(0xFF)
    return vals.astype(np.uint8).reshape(flat)


def unpack_u32_to_f32(packed: torch.Tensor, *, scale: float = 1.0 / 255.0,
                      shift: float = 0.0) -> torch.Tensor:
    """Decode + normalise in one op, the paper's "custom decode layer".

    The plain oracle of the decode kernel; models call
    ``repro_torch.kernels.pack.ops.decode``, which dispatches on the
    tensor's device."""
    u8 = unpack_u32_to_u8(packed)
    return u8.to(torch.float32) * scale + shift


def compression_ratio(n_images: int, codec: str = "u32") -> float:
    """Host->device byte ratio vs sending raw float32 images (the paper's
    'saves up-to 16X memory and passage time' accounting)."""
    if codec == "u32":      # u32 container carries 4 u8 images vs 4 f32 images
        return 16.0         # 4 imgs * 4 B/px f32  ->  1 * 4 B/px u32
    if codec == "base256":  # f64 container, N imgs vs N f32 images
        return n_images * 4.0 / 8.0
    raise ValueError(codec)


# ---------------------------------------------------------------------------
# Selective-batch-sampling (SBS), paper Algorithm 2.
# ---------------------------------------------------------------------------
def selective_batch_indices(
    labels: np.ndarray,
    class_weights: Mapping[int, float] | Sequence[float],
    batch_size: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Select ``batch_size`` example indices honouring per-class weights.

    ``W[i] * batch_size`` examples of class ``UC[i]`` per batch (Alg. 2).
    Rounding residue is assigned to the highest-weight classes.
    """
    labels = np.asarray(labels)
    classes = np.unique(labels)
    if not isinstance(class_weights, Mapping):
        class_weights = {int(c): float(w)
                         for c, w in zip(classes, class_weights)}
    w = np.array([class_weights.get(int(c), 0.0) for c in classes],
                 dtype=np.float64)
    if w.sum() <= 0:
        raise ValueError("class weights sum to zero")
    w = w / w.sum()
    counts = np.floor(w * batch_size).astype(int)
    # distribute the remainder by largest fractional part
    frac = w * batch_size - counts
    for i in np.argsort(-frac)[: batch_size - counts.sum()]:
        counts[i] += 1
    picks = []
    for c, k in zip(classes, counts):
        if k == 0:
            continue
        pool = np.flatnonzero(labels == c)
        picks.append(rng.choice(pool, size=k, replace=len(pool) < k))
    idx = np.concatenate(picks) if picks else np.empty((0,), np.int64)
    rng.shuffle(idx)
    return idx


def sbs_batches(
    labels: np.ndarray,
    class_weights,
    batch_size: int,
    num_batches: int,
    seed: int = 0,
    preprocess: Mapping[int, Callable[[np.ndarray], np.ndarray]] | None = None,
):
    """Yield (indices, class_fn_map) per batch; per-class augmentation hooks
    (MixUp/CutMix/AugMix slots in the paper) are applied by the loader."""
    rng = np.random.default_rng(seed)
    for _ in range(num_batches):
        yield selective_batch_indices(labels, class_weights, batch_size,
                                      rng), (preprocess or {})
