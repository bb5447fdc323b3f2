"""Seeded token sampling (counterpart of ``repro.serve.sampling``).

Greedy (``temperature <= 0``) is exact argmax and the default.  Two
sampling schedules:

* per batch (:func:`sample_tokens`): one ``torch.Generator`` draws every
  row of a batch -- the lockstep mode's sampler;
* per row (:func:`sample_tokens_per_row` with :func:`fold_request_key`):
  row i samples with its own key.  The engine folds that key from
  ``(seed, key_id, draw)`` in ``sampler_keys="request"`` mode, so token
  ``draw`` of request ``key_id`` samples identically on any replica,
  slot or step, beside any co-tenants: what keeps a migrated or
  recovered request's trajectory (the router's mode).  Its "step" mode
  folds ``(seed, sampler call, row)`` instead, JAX's per-round schedule.

The keys are the port's own pure function: a 32-bit counter hash of
``(seed, key_id, draw, vocab index)`` turned into a uniform and then
Gumbel noise, the token ``argmax(logits / T + g)`` over the top-k row
(the Gumbel-max form of exact categorical sampling), in one vectorized
pass over the (B, V) batch on the logits' device.  It cannot reproduce
``jax.random``'s numbers, so sampled output is not comparable across the
two packages; both are placement-independent in "request" mode.
"""
from __future__ import annotations

import functools

import torch

_MASK32 = 0xFFFFFFFF
_MIX = 0x45D9F3B            # < 2**31: a 32-bit value times it fits int64
_GOLDEN = 0x9E3779B9


def _mix32(x):
    """A 32-bit integer finalizer on Python ints or int64 tensors holding
    values in [0, 2**32); no product leaves int64, so it is the same
    function on every device."""
    x = x ^ (x >> 16)
    x = (x * _MIX) & _MASK32
    x = x ^ (x >> 16)
    x = (x * _MIX) & _MASK32
    return x ^ (x >> 16)


def _fold(key, data):
    """Fold ``data`` into ``key`` (both 32-bit; ints or int64 tensors)."""
    return _mix32(key ^ _mix32((data + _GOLDEN) & _MASK32))


def fold_request_key(seed, key_id, draw):
    """The per-request key schedule: token ``draw`` of request ``key_id``
    always samples with the same 32-bit key, wherever it runs.  Takes
    Python ints or int64 tensors (elementwise)."""
    return _fold(_fold(_mix32(seed & _MASK32), key_id & _MASK32),
                 draw & _MASK32)


def _top_k_mask(scaled: torch.Tensor, top_k: int) -> torch.Tensor:
    if 0 < top_k < scaled.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    return scaled


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
    probs = torch.softmax(_top_k_mask(logits.float() / float(temperature),
                                      top_k), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def gumbel_noise(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B,) int64 keys -> (B, vocab) f64 standard Gumbel noise, entry (b, v)
    a pure function of ``(keys[b], v)``: the uniform is the hash's 32 bits
    centred in their cell, so it lies strictly inside (0, 1)."""
    v = torch.arange(vocab, dtype=torch.int64, device=keys.device)
    h = _fold(keys.to(torch.int64)[:, None], v[None, :])
    u = (h.to(torch.float64) + 0.5) * 2.0 ** -32
    return -torch.log(-torch.log(u))


def sampling_scores(logits: torch.Tensor, keys=None, *,
                    temperature: float = 0.0, top_k: int = 0):
    """logits: (B, V), keys: (B,) int64 row keys (:func:`fold_request_key`)
    -> (B, V) scores whose row argmax is the sampled token: the logits
    themselves when ``temperature <= 0`` (greedy, keys unused), else
    ``logits / T + Gumbel(key)`` in f64 over the row's top k."""
    if temperature <= 0.0:
        return logits
    if keys is None:
        raise ValueError("sampling_scores: temperature > 0 needs per-row "
                         "keys")
    scaled = _top_k_mask(logits.double() / float(temperature), top_k)
    return scaled + gumbel_noise(keys, logits.shape[-1])


def sample_tokens_per_row(logits: torch.Tensor, keys=None, *,
                          temperature: float = 0.0, top_k: int = 0):
    """logits: (B, V), keys: (B,) int64 -> (B,) int32, each row sampled
    with ITS OWN key: the argmax of :func:`sampling_scores`.
    ``temperature <= 0`` is exact greedy (identical to
    :func:`sample_tokens`)."""
    return sampling_scores(logits, keys, temperature=temperature,
                           top_k=top_k).argmax(dim=-1).to(torch.int32)


def make_sampler(*, temperature: float = 0.0, top_k: int = 0):
    """A (logits, generator) -> tokens callable with fixed knobs."""
    return functools.partial(sample_tokens, temperature=temperature,
                             top_k=top_k)
