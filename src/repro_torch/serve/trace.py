"""Synthetic request traces: seeded arrivals + length distributions.

The engine's unit of time is the engine STEP (one decode round): arrivals
land on step boundaries, which keeps traces deterministic and replayable
across machines — no wall-clock sleeps baked into a benchmark input.
Prompt and generation lengths draw from clipped geometric distributions
(the classic heavy-ish tail of chat traffic, cheap to reason about).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    arrival_step: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int


def synthetic_trace(n_requests: int, *, seed: int = 0, vocab: int = 256,
                    mean_prompt: int = 24, max_prompt: int = 48,
                    mean_gen: int = 12, max_gen: int = 32,
                    arrival_rate: float = 0.5,
                    min_prompt: int = 4) -> list[TraceRequest]:
    """``arrival_rate`` is requests per engine step, capped at one
    arrival per step (Bernoulli thinning: inter-arrival gaps are
    geometric with mean ``1/arrival_rate`` steps, minimum 1; rates > 1
    clamp to 1).  The first request arrives at step 0.  Same seed, same
    trace."""
    if not (0 < arrival_rate):
        raise ValueError("synthetic_trace: arrival_rate must be > 0")
    rng = np.random.default_rng(seed)
    reqs: list[TraceRequest] = []
    step = 0
    for i in range(n_requests):
        if i:
            step += int(rng.geometric(min(1.0, arrival_rate)))
        p_len = int(np.clip(rng.geometric(1.0 / max(1, mean_prompt)),
                            min_prompt, max_prompt))
        g_len = int(np.clip(rng.geometric(1.0 / max(1, mean_gen)),
                            1, max_gen))
        prompt = rng.integers(0, vocab, (p_len,), dtype=np.int32)
        reqs.append(TraceRequest(arrival_step=step, prompt=prompt,
                                 max_new_tokens=g_len))
    return reqs
