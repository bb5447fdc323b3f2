"""Synthetic datasets (offline: no downloads).  ``token_stream`` is a copy
of ``repro.data.synthetic.token_stream`` (numpy only), a deterministic
pseudo-corpus for LM training; the CIFAR-like images come with the
paper's encode/decode pipeline (slice D).
"""
from __future__ import annotations

import numpy as np


def token_stream(n_tokens: int, vocab: int, seed: int = 0) -> np.ndarray:
    """Markov-ish deterministic token stream (learnable bigram structure)."""
    rng = np.random.default_rng(seed)
    toks = np.empty(n_tokens, dtype=np.int32)
    t = rng.integers(0, vocab)
    for i in range(n_tokens):
        toks[i] = t
        # strongly-biased successor: learnable structure
        t = (t * 31 + 7) % vocab if rng.random() < 0.8 else rng.integers(0, vocab)
    return toks
