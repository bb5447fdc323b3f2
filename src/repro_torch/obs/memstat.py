"""Planner-vs-live memory reconciliation (counterpart of
``repro.obs.memstat``).

The planner (``repro_torch.plan``) predicts peak bytes; ``MemStat.sample``
reads what is resident and scores it against the plan: ``mem_sample``
events carry ``frac_of_plan``, so a trace shows when live bytes cross the
planned peak.  On the card ``live_bytes`` is the caching allocator's
``torch.cuda.memory_allocated`` (the bytes of live tensors) and
``device_peak_bytes`` its ``max_memory_allocated``; ``n_arrays`` counts
its live allocations.  On the CPU there is no such counter and
``live_bytes`` is -1, as the JAX package's is on a backend without
live-array support.  ``replica`` (a fleet replica's index) is put on
every record, as the reference's ``MemStat(replica=)`` does.
"""
from __future__ import annotations

import torch


class MemStat:
    def __init__(self, *, sink=None, registry=None, plan_bytes=None,
                 device=None, replica=None) -> None:
        self.sink = sink
        self.registry = registry
        self.plan_bytes = plan_bytes
        self.replica = replica
        self.device = None if device is None else torch.device(device)
        self.peak_bytes = 0
        self.samples = 0

    def sample(self, step: int) -> dict:
        """Read the allocator (no device sync) and emit ``mem_sample``."""
        dev_peak = None
        if self.device is not None and self.device.type == "cuda":
            live = torch.cuda.memory_allocated(self.device)
            n = torch.cuda.memory_stats(self.device).get(
                "allocation.all.current", -1)
            dev_peak = torch.cuda.max_memory_allocated(self.device)
        else:                                   # no allocator counters
            live = n = -1
        rec = {"step": step, "live_bytes": live, "n_arrays": n}
        if dev_peak is not None:
            rec["device_peak_bytes"] = dev_peak
        if self.plan_bytes:
            rec["plan_bytes"] = int(self.plan_bytes)
            rec["frac_of_plan"] = round(live / self.plan_bytes, 4) \
                if live >= 0 else None
        if self.replica is not None:
            rec["replica"] = self.replica
        self.samples += 1
        if live > self.peak_bytes:
            self.peak_bytes = live
        if self.registry is not None:
            self.registry.set("mem.live_bytes", live)
            self.registry.observe("mem.live_mb", live / 2**20)
        if self.sink is not None:
            self.sink.emit("mem_sample", **rec)
        return rec

    def banner(self) -> str:
        """One line for the launch banner."""
        peak_mb = self.peak_bytes / 2**20
        if self.plan_bytes:
            return (f"mem: live peak {peak_mb:.1f} MB, plan "
                    f"{self.plan_bytes / 2**20:.1f} MB "
                    f"({self.peak_bytes / self.plan_bytes:.2f}x) "
                    f"over {self.samples} samples")
        return f"mem: live peak {peak_mb:.1f} MB over {self.samples} samples"
