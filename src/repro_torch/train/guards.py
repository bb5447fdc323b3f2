"""Training fault guards: NaN/Inf grad sentinel + rolling-median
loss-spike detection with escalating skip-step → rollback (a copy of
``repro.train.guards``, which imports no JAX).

Detection is two-tier, matching where each fault is cheapest to catch:

* **non-finite grads** are caught ON THE DEVICE: ``core.mixed_precision``'s
  all-finite check already rides every train step (it drives fp16
  loss scaling), and ``adamw.update(skip=...)`` zeroes the update when
  it trips — ``TrainConfig.skip_nonfinite`` turns that on outside the
  fp16 path.  The guard only *counts* these (via the step's
  ``grads_finite`` metric) and escalates;
* **loss spikes** are caught HOST-side after the step, by comparing the
  step loss against a rolling median of recent *healthy* losses
  (HomebrewNLP-Jax's wandblog idiom: median, not mean — one spike must
  not drag the baseline up).  A spiked step's params are already
  updated; the guard quarantines the loss out of the history and
  escalates instead of pretending it can un-apply the update.

Escalation: each bad step (non-finite or spike) grows ``bad_streak``;
an isolated bad step is **skipped** (logged, excluded from history),
``rollback_after`` consecutive bad steps return ``ROLLBACK`` — the
driver restores the last good checkpoint via ``CheckpointManager`` and
replays from there (``launch/train.py --guard``).  Healthy steps reset
the streak.

With a ``sink`` (``repro_torch.events.EventSink``) every non-OK verdict
streams to the append-only JSONL log as it happens — over a multi-hour
run the skip/rollback history survives the process
(``launch/train.py --events`` wires it).  With a ``registry``
(:class:`repro_torch.obs.MetricsRegistry`) every verdict ALSO retires
into bounded-memory counters + streaming histograms (loss, grad norm).
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from collections import deque


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    window: int = 32          # healthy losses kept for the rolling median
    spike_factor: float = 4.0  # loss > factor * median(window) => spike
    min_history: int = 5      # no spike verdicts until this many healthy
    rollback_after: int = 3   # consecutive bad steps that trigger rollback

    def __post_init__(self):
        if self.window < 1 or self.min_history < 1:
            raise ValueError("GuardConfig: window and min_history must be "
                             ">= 1")
        if self.spike_factor <= 1.0:
            raise ValueError("GuardConfig: spike_factor must be > 1 "
                             "(a factor <= 1 flags ordinary noise)")
        if self.rollback_after < 1:
            raise ValueError("GuardConfig: rollback_after must be >= 1")


class TrainGuard:
    """Per-step verdicts: ``OK`` | ``SKIP`` | ``ROLLBACK`` (see module
    docstring for the escalation contract)."""

    OK, SKIP, ROLLBACK = "ok", "skip", "rollback"

    def __init__(self, cfg: GuardConfig = GuardConfig(), *, sink=None,
                 registry=None):
        self.cfg = cfg
        self.sink = sink                  # optional EventSink (JSONL)
        self.registry = registry          # optional obs.MetricsRegistry
        self._window: deque[float] = deque(maxlen=cfg.window)
        self._step = 0
        self.bad_streak = 0
        self.nonfinite = 0
        self.spikes = 0
        self.skipped = 0
        self.rollbacks = 0

    def median(self) -> float | None:
        return statistics.median(self._window) if self._window else None

    def observe(self, loss: float, grads_finite: bool = True,
                grad_norm: float | None = None) -> str:
        """Judge one completed step.  Healthy losses enter the rolling
        window; bad ones never do (a spike must not poison the baseline
        that detects the next spike).  ``grad_norm`` is optional — pass
        it only if the driver already has it on host (the guard never
        forces a device sync)."""
        reason = None
        if not grads_finite or not math.isfinite(loss):
            reason = "nonfinite"
            self.nonfinite += 1
        elif (len(self._window) >= self.cfg.min_history
              and loss > self.cfg.spike_factor
              * statistics.median(self._window)):
            reason = "spike"
            self.spikes += 1
        self._step += 1
        reg = self.registry
        if reg is not None:
            if math.isfinite(loss):
                reg.observe("train.loss", float(loss))
            if grad_norm is not None and math.isfinite(grad_norm):
                reg.observe("train.grad_norm", float(grad_norm))
        if reason is None:
            self._window.append(float(loss))
            self.bad_streak = 0
            if reg is not None:
                reg.inc("guard.ok")
            return self.OK
        self.bad_streak += 1
        if self.bad_streak >= self.cfg.rollback_after:
            self.rollbacks += 1
            self.bad_streak = 0
            if reg is not None:
                reg.inc("guard.rollback")
            self._emit("guard_rollback", reason=reason, loss=float(loss))
            return self.ROLLBACK
        self.skipped += 1
        if reg is not None:
            reg.inc("guard.skip")
        self._emit("guard_skip", reason=reason, loss=float(loss),
                   streak=self.bad_streak)
        return self.SKIP

    def _emit(self, kind: str, **fields) -> None:
        if self.sink is not None:
            self.sink.emit(kind, guard_step=self._step, **fields)

    def reset_history(self) -> None:
        """Forget the loss window + streak — call after a rollback: the
        restored params' losses get a fresh baseline."""
        self._window.clear()
        self.bad_streak = 0

    def counters(self) -> dict:
        return {"nonfinite": self.nonfinite, "spikes": self.spikes,
                "skipped": self.skipped, "rollbacks": self.rollbacks,
                "bad_streak": self.bad_streak,
                "window": len(self._window)}
