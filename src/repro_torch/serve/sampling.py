"""Seeded token sampling (counterpart of ``repro.serve.sampling``).

Greedy (``temperature <= 0``) is exact argmax and the default.  Sampling
draws from a ``torch.Generator``; it cannot reproduce ``jax.random``'s
numbers, so only greedy output is comparable across the two packages.
The per-request key schedule (``fold_request_key``) comes with the router.
"""
from __future__ import annotations

import functools

import torch


def sample_tokens(logits: torch.Tensor, gen: torch.Generator | None = None,
                  *, temperature: float = 0.0, top_k: int = 0):
    """logits: (B, V) -> (B,) int32 sampled token per row.

    ``temperature <= 0`` is greedy (``gen`` unused).  Otherwise softmax
    sampling at ``temperature``, optionally restricted to the ``top_k``
    highest logits per row (0 = full vocab)."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    if gen is None:
        raise ValueError("sample_tokens: temperature > 0 needs a generator")
    scaled = logits.float() / float(temperature)
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def make_sampler(*, temperature: float = 0.0, top_k: int = 0):
    """A (logits, generator) -> tokens callable with fixed knobs."""
    return functools.partial(sample_tokens, temperature=temperature,
                             top_k=top_k)
