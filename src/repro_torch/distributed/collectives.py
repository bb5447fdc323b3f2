"""Explicit collectives over ``torch.distributed`` process groups
(counterpart of ``repro.distributed.collectives``): the compressed DP
all-reduce.

The train step's own DP reduction is the plain f32 mean
(``train/train_step.py``), as the reference leaves it to XLA; this is
the hand-rolled equivalent for gradient compression over slow links, a
library function as in the reference.  The sequence-parallel decode
collectives (``sp_decode_attention`` / ``_int8``) come with the serving
half of the distributed slice.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

from repro_torch.optim import compression


def rank_payload(grads: Mapping, seed: int, rank: int) -> dict:
    """The int8 payload rank ``rank`` puts on the wire for ``grads``:
    ``{name: (q, scale)}``, leaf ``i`` (sorted names) rounded with noise
    seeded from ``(seed, rank, i)``."""
    return {name: compression.quantize_int8(
                grads[name], compression.generator_for(grads[name], seed,
                                                       rank, i))
            for i, name in enumerate(sorted(grads))}


def compressed_psum_grads(grads: Mapping, group=None, seed: int = 0, *,
                          codec: str = "int8") -> dict:
    """Mean all-reduce of this rank's gradients over ``group`` (default:
    the whole world), int8 payloads.

    Each rank quantizes its OWN gradients to int8 with a rank-folded
    stochastic-rounding seed: decorrelated noise is what makes the mean
    unbiased (a shared seed would correlate the rounding errors and they
    would no longer average out).  The reduction runs on the dequantized
    values in f32, one ``all_reduce(SUM)`` over the leaves concatenated,
    divided by the group size; the int8 payload (:func:`rank_payload`,
    ``compression.payload_bytes``) is what would cross the links: bytes
    are accounted, the wire format is not changed.  Every rank gets the
    same mean."""
    if codec != "int8":
        raise ValueError(f"compressed_psum_grads: codec {codec!r}; only "
                         f"'int8' is reduced")
    rank = dist.get_rank(group)
    n = dist.get_world_size(group)
    names = sorted(grads)
    payload = rank_payload(grads, seed, rank)
    flat = torch.cat([compression.dequantize_int8(*payload[k]).reshape(-1)
                      for k in names])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= n
    out, at = {}, 0
    for k in names:
        m = grads[k].numel()
        out[k] = flat[at:at + m].reshape(grads[k].shape)
        at += m
    return out
