"""Slot-indexed KV pool (counterpart of ``repro.serve.cache_pool``).

The pool preallocates ONE decode cache at ``(max_slots, max_len)`` on the
device and treats each batch row as a slot whose lifetime is a request's
lifetime; the free-list and alloc/free accounting live on the host.
``scatter_request`` copies a prefilled request cache into its slot in
place.  Retirement is free: the slot's rows stop being read and the next
scatter overwrites them.

Over a mesh's model axis (``mesh=``) the pool holds this rank's block of
the cache, laid out by ``sharding.serve_cache_specs``: its KV heads
("heads"), or its ``S_l = max_len / n`` positions ``[r S_l, (r+1) S_l)``
("seq").  The slot axis is never split: every rank holds its block of
every slot, so the free-list is the same on every rank.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def scatter_request(pool_cache: dict, req_cache: dict, slot: int,
                    length: int, *, seq_offset: int | None = None) -> dict:
    """Copy a prefilled request cache (batch dim 1) into ``slot`` of the
    pool, in place, and stamp the slot's length.  Returns ``pool_cache``.

    Without ``seq_offset`` the request's sequence axis must already be
    grown to the pool's ``max_len``.  With it the pool holds the global
    positions ``[seq_offset, seq_offset + S_pool)`` (a sequence-sharded
    pool's block; 0 for one that holds every position) and the request
    cache may be of any length up to ``max_len`` (its prompt bucket):
    the positions that fall in the block are copied by global position
    and the rest of the slot's block is zeroed, as a grown cache's tail
    would be."""
    for name, ax in transformer.CACHE_SEQ_AXES.items():
        if name not in pool_cache:      # the other layout's leaves
            continue
        upd = req_cache[name]
        dst = pool_cache[name][:, slot]             # (L, B, ...) batch axis
        s_pool = dst.shape[ax - 1]
        if seq_offset is None:
            if upd.shape[ax] != s_pool:
                raise ValueError(
                    f"scatter_request: {name} has {upd.shape[ax]} sequence "
                    f"slots, pool holds {s_pool} -- grow the prefill cache "
                    f"to max_len first (transformer.grow_cache)")
            dst.copy_(upd[:, 0])
            continue
        transformer.place_seq(dst, upd[:, 0], ax - 1, seq_offset)
    pool_cache["pos"][slot] = length
    return pool_cache


class SlotPool:
    """Preallocated slot-pooled decode cache + host-side free-list.

    Every ``alloc`` is matched by exactly one ``free``; once a trace drains,
    ``allocs == frees`` and ``occupancy == 0`` (asserted in tests)."""

    def __init__(self, cfg: ModelConfig, max_slots: int, max_len: int, *,
                 quantized: bool = True, device="cuda", mesh=None):
        if max_slots < 1:
            raise ValueError(f"SlotPool: max_slots must be >= 1, "
                             f"got {max_slots}")
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.quantized = quantized
        self.mesh = mesh
        self.cache = transformer.init_cache(cfg, max_slots, max_len,
                                            quantized=quantized,
                                            device=device, mesh=mesh)
        #: ``{leaf: spec}`` of the pool's cache on ``mesh`` (None: no mesh)
        #: and the first global position this rank's block holds
        self.specs = None
        self.seq_offset = 0
        if mesh is not None:
            shapes = {n: tuple(x.shape) for n, x in transformer.init_cache(
                cfg, max_slots, max_len, quantized=quantized,
                device="meta").items()}
            self.specs = shd.serve_cache_specs(cfg, shapes, mesh)
            self.seq_offset = transformer.seq_block(cfg, mesh, max_len)[0]
        # per-slot lengths replace the lockstep scalar position
        self.cache["pos"] = torch.zeros((max_slots,), dtype=torch.int32,
                                        device=device)
        self._free = list(range(max_slots - 1, -1, -1))   # pop() -> slot 0
        self._live: set[int] = set()
        self._quarantined: set[int] = set()
        self.allocs = 0
        self.frees = 0
        self.quarantines = 0

    # -- host-side lifetime management ------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> int:
        return len(self._live)

    @property
    def quarantined(self) -> int:
        return len(self._quarantined)

    def alloc(self) -> int | None:
        """Claim a free slot id, or None when the pool is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._live.add(slot)
        self.allocs += 1
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._live:
            raise ValueError(f"SlotPool.free: slot {slot} is not live "
                             f"(double free or foreign slot)")
        self._live.remove(slot)
        self._free.append(slot)
        self.frees += 1

    # -- fault quarantine --------------------------------------------------
    def quarantine(self, slot: int) -> None:
        """Pull a poisoned live slot out of circulation until the engine has
        audited the pool; :meth:`release_quarantined` counts its free."""
        if slot not in self._live:
            raise ValueError(f"SlotPool.quarantine: slot {slot} is not "
                             f"live")
        self._live.remove(slot)
        self._quarantined.add(slot)
        self.quarantines += 1

    def release_quarantined(self) -> list[int]:
        """Return quarantined slots to the free list (call after
        :meth:`audit` passes; the next scatter overwrites their rows)."""
        released = sorted(self._quarantined)
        for slot in released:
            self._quarantined.remove(slot)
            self._free.append(slot)
            self.frees += 1
        return released

    def audit(self) -> dict:
        """Verify that free / live / quarantined partition the slots and
        that the counters reconcile; raise on corruption."""
        free = set(self._free)
        report = {"free": len(free), "live": len(self._live),
                  "quarantined": len(self._quarantined),
                  "allocs": self.allocs, "frees": self.frees}
        if len(free) != len(self._free):
            raise RuntimeError(f"SlotPool.audit: duplicate slots on the "
                               f"free list ({sorted(self._free)})")
        overlap = (free & self._live) | (free & self._quarantined) \
            | (self._live & self._quarantined)
        if overlap:
            raise RuntimeError(f"SlotPool.audit: slots in two states: "
                               f"{sorted(overlap)}")
        missing = set(range(self.max_slots)) - free - self._live \
            - self._quarantined
        if missing:
            raise RuntimeError(f"SlotPool.audit: slots leaked out of all "
                               f"states: {sorted(missing)}")
        outstanding = len(self._live) + len(self._quarantined)
        if self.allocs - self.frees != outstanding:
            raise RuntimeError(
                f"SlotPool.audit: allocs({self.allocs}) - "
                f"frees({self.frees}) != live+quarantined({outstanding})")
        return report

    # -- accounting --------------------------------------------------------
    def _shards(self, name: str) -> int:
        return 1 if self.specs is None else \
            shd.spec_shards(self.mesh, self.specs[name])

    def bytes_per_slot(self) -> int:
        """Bytes one resident request pins over all devices (the whole
        cache's bytes / slots)."""
        total = sum(x.numel() * x.element_size() * self._shards(k)
                    for k, x in self.cache.items() if k != "pos")
        return total // self.max_slots

    def bytes_per_slot_per_device(self) -> int:
        """Bytes one resident request pins on each device, what a byte
        budget admits against: the sharded leaves divided by their shard
        count (``sharding.spec_shards``), i.e. this rank's block.  Equals
        :meth:`bytes_per_slot` without a mesh."""
        total = sum(x.numel() * x.element_size()
                    for k, x in self.cache.items() if k != "pos")
        return total // self.max_slots
