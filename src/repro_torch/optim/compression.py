"""Gradient compression with error feedback (counterpart of
``repro.optim.compression``), over ``{name: tensor}`` dicts.

Two codecs for the DP gradient reduction:
  * int8 per-leaf-scaled quantization with stochastic rounding: 4x fewer
    reduction bytes than f32, unbiased;
  * top-k sparsification: the k largest-magnitude entries of each leaf.

Both keep an error-feedback residual (added back next step) so the
compression error does not accumulate as bias.  Leaves are taken in
sorted-name order (the order ``jax.tree_util`` flattens a dict in), and
leaf ``i`` draws its rounding noise, ``U[-0.5, 0.5)``, from a
``torch.Generator`` of its own seeded from ``(seed, i)``: the draws are
PyTorch's, not ``jax.random``'s, so the int8 codes agree with the
reference's in distribution, not bit for bit.  ``torch.round`` rounds
half to even, as ``jnp.round`` does.  ``distributed/collectives.py``
``compressed_psum_grads`` is the DP reduction built on it.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def generator_for(x: torch.Tensor, *key: int) -> torch.Generator:
    """A generator on ``x``'s device seeded from the integers ``key``
    (``numpy.random.SeedSequence`` mixes them into 64 bits)."""
    seed = int(np.random.SeedSequence([int(k) for k in key])
               .generate_state(1, np.uint64)[0])
    return torch.Generator(device=x.device).manual_seed(seed)


def quantize_int8(x: torch.Tensor, generator: torch.Generator
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 codes, f32 scale): ``scale = max|x| / 127`` (1 for an
    all-zero ``x``), codes ``round(x / scale + U[-0.5, 0.5))`` clipped to
    [-127, 127]."""
    x = x.float()
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    noise = torch.rand(x.shape, generator=generator, device=x.device,
                       dtype=torch.float32) - 0.5
    q = torch.clamp(torch.round(x / scale + noise), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grads: Mapping, residual: Mapping | None,
                           seed: int, *, codec: str = "int8",
                           topk_frac: float = 0.01) -> tuple[dict, dict]:
    """-> (payload, new residual).  Payload leaves are ``(q, scale)`` or
    ``(values, int32 indices)``: what would cross the DP links."""
    payload, new_res = {}, {}
    for i, name in enumerate(sorted(grads)):
        g = grads[name].float()
        if residual is not None:
            g = g + residual[name]
        if codec == "int8":
            q, s = quantize_int8(g, generator_for(g, seed, i))
            recon = dequantize_int8(q, s)
            payload[name] = (q, s)
        elif codec == "topk":
            kk = max(1, int(g.numel() * topk_frac))
            flat = g.reshape(-1)
            idx = torch.topk(flat.abs(), kk).indices
            kept = flat[idx]
            recon = torch.zeros_like(flat).index_put_(
                (idx,), kept).reshape(g.shape)
            payload[name] = (kept, idx.to(torch.int32))
        else:
            raise ValueError(codec)
        new_res[name] = g - recon
    return payload, new_res


def decompress(payload: Mapping, like: Mapping, *,
               codec: str = "int8") -> dict:
    out = {}
    for name in sorted(like):
        a, b = payload[name]
        shape = like[name].shape
        if codec == "int8":
            out[name] = dequantize_int8(a, b).reshape(shape)
        else:
            flat = torch.zeros(like[name].numel(), dtype=torch.float32,
                               device=a.device)
            out[name] = flat.index_put_((b.long(),), a).reshape(shape)
    return out


def payload_bytes(payload: Mapping) -> int:
    return sum(x.numel() * x.element_size()
               for leaf in payload.values() for x in leaf)
