"""Synthetic datasets (offline: no downloads), copies of
``repro.data.synthetic`` (numpy only), so a given seed gives the same data
in both packages.

``make_cifar_like`` produces a learnable image-classification task with the
CIFAR-10 geometry (32x32x3 uint8, 10 classes): each class has a distinct
smooth template + noise, so small CNNs reach high accuracy within a few
hundred steps -- enough to show the paper's "same accuracy" parity claims
between pipelines without the real dataset.

``token_stream`` produces a deterministic pseudo-corpus for LM training.
"""
from __future__ import annotations

import numpy as np


def make_cifar_like(n: int = 2048, num_classes: int = 10, hw: int = 32,
                    channels: int = 3, seed: int = 0, noise: float = 24.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float64) / hw
    templates = []
    for c in range(num_classes):
        freq = 1 + c % 5
        phase = 2 * np.pi * c / num_classes
        base = 127 + 100 * np.sin(2 * np.pi * freq * xx + phase) * np.cos(
            2 * np.pi * (c // 5 + 1) * yy
        )
        templates.append(np.stack([np.roll(base, k * 3, axis=1)
                                   for k in range(channels)], -1))
    templates = np.stack(templates)  # (C, H, W, ch)
    labels = rng.integers(0, num_classes, size=n)
    imgs = templates[labels] + rng.normal(0, noise,
                                          size=(n, hw, hw, channels))
    return np.clip(imgs, 0, 255).astype(np.uint8), labels.astype(np.int32)


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
