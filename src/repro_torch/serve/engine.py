"""Continuous-batching serve engine on one device (counterpart of
``repro.serve.engine``).

One engine step = deadline shedding + (bounded) admissions + one decode
round:

* admission: FCFS requests claim a pool slot, prefill at batch 1 over a
  power-of-two prompt BUCKET (padded; under causal attention the padded
  suffix never touches the prefix, so the cache rows and the last valid
  logit equal an unpadded prefill's), are copied into the slot, and sample
  their first token (TTFT).  On the card the prefill runs the flash
  kernel once per layer;
* decode: one step over the whole pool at ``(max_slots, max_len)``;
  occupancy lives in the per-slot ``pos`` lengths and the active mask, and
  on the card every layer runs the split-K int8 decode kernel, whose
  length-aware loop never loads the padded tail of a slot.

Fault tolerance, as in the JAX engine: a health sentinel rides in the
sampled token (a tripped slot yields -1: non-finite logits, a token
outside the vocab, or a slot whose prompt was never scattered), the slot
is quarantined, the pool audited, and the request replays from its prompt
plus its healthy tokens with a bounded retry budget.  Deadlines, a
bounded queue, ``cancel`` and ``drain`` work as there.

Instead of ``compile_counts`` (PyTorch runs eagerly and compiles nothing)
the engine reports the two kernels' launch counters
(:func:`kernel_launches`) and its own prefill / decode-round counts, so a
run shows that its main path went through the kernels.  The mesh, the
request-keyed sampler, the tracer and the memory budget come with later
slices.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.mixed_precision import get_policy
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.kvq import ops as kvq_ops
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serve import sampling
from repro_torch.serve.cache_pool import SlotPool, scatter_request
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import (CANCELLED, DECODE, FAILED, QUEUED,
                                         TERMINAL, AdmissionRejected, Request,
                                         Scheduler)
from repro_torch.serve.trace import TraceRequest


#: engine steps a replay waits at the head of the queue, per retry
RETRY_BACKOFF_STEPS = 1


def default_buckets(max_len: int, lo: int = 16) -> tuple[int, ...]:
    """Power-of-two prompt buckets below max_len."""
    out = []
    b = lo
    while b < max_len:
        out.append(b)
        b *= 2
    return tuple(out) or (max_len,)


def supports(cfg: ModelConfig) -> bool:
    """Engine eligibility: the slot-pooled per-row decode path needs the
    GQA int8 cache layout and a uniform full-causal schedule."""
    return (cfg.mixer == "attn" and cfg.mla is None and cfg.encoder is None
            and not cfg.global_layers and cfg.window == 0)


def kernel_launches() -> dict:
    """Launch counters of the serving path's two CUDA kernels."""
    return {"flash_fwd": flash_ops.KERNEL.launches,
            "flash_decode": kvq_ops.KERNEL.launches}


class ServeEngine:
    """Slot-pooled continuous-batching engine (see module docstring)."""

    def __init__(self, model: transformer.Transformer, cfg: ModelConfig, *,
                 max_slots: int, max_len: int, policy_name: str = "bf16",
                 quantized: bool = True, kv_splits: int = 1,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 max_prefill_per_step: int = 1,
                 max_queue: Optional[int] = None,
                 deadline_steps: Optional[int] = None,
                 max_retries: int = 2):
        if not supports(cfg):
            raise NotImplementedError(
                "ServeEngine needs a GQA attention arch with a full-causal "
                "uniform schedule (no MLA latents, SSM state, encoder "
                "cross-attention, windows or per-layer overrides)")
        if max_retries < 0:
            raise ValueError("ServeEngine: max_retries must be >= 0")
        self.cfg = cfg
        self.max_len = max_len
        self.quantized = quantized
        self.kv_splits = kv_splits
        self.deadline_steps = deadline_steps
        self.max_retries = max_retries
        self.temperature, self.top_k = float(temperature), int(top_k)
        #: host-side interception points ("pre_step", "pre_decode",
        #: "scatter_filter") -- the fault-injection seam
        self.hooks: dict[str, Callable] = {}
        self.policy = get_policy(policy_name)
        # the one cast to the compute dtype (a no-op for a model built in it)
        self.model = model.cast_to_compute(self.policy)
        self.device = self.model.embed.device
        self.pool = SlotPool(cfg, max_slots, max_len, quantized=quantized,
                             device=self.device)
        self.scheduler = Scheduler(
            max_slots, bytes_per_slot=self.pool.bytes_per_slot(),
            max_prefill_per_step=max_prefill_per_step, max_queue=max_queue)
        self.metrics = ServeMetrics()
        self.buckets = default_buckets(max_len)
        self._seed = seed
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._sampler = sampling.make_sampler(temperature=self.temperature,
                                              top_k=self.top_k)
        self._step_no = 0
        self._next_rid = 0
        self._draining = False
        self.n_prefills = 0
        self.n_decode_rounds = 0
        self._slot_req: dict[int, Request] = {}
        self._requests: dict[int, Request] = {}            # every rid ever
        self._requests_done: list[Request] = []
        self._tokens_dev = torch.zeros((max_slots,), dtype=torch.int32,
                                       device=self.device)
        self._active_dev = torch.zeros((max_slots,), dtype=torch.bool,
                                       device=self.device)
        self._active_buf = np.zeros((max_slots,), bool)    # host mirror

    # -- public API --------------------------------------------------------
    @property
    def step_no(self) -> int:
        return self._step_no

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None) -> int:
        """Queue a request; returns its rid.  ``eos_id`` ends generation
        early when sampled.  Raises :class:`AdmissionRejected` when the
        bounded queue is full."""
        prompt = np.asarray(prompt, np.int32)
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      arrival_step=self._step_no, eos_id=eos_id,
                      deadline_steps=self.deadline_steps)
        if req.prompt_len > self.buckets[-1]:
            raise ValueError(f"request {req.rid}: prompt_len "
                             f"{req.prompt_len} exceeds largest bucket "
                             f"{self.buckets[-1]}")
        if req.total_len() > self.max_len:
            raise ValueError(f"request {req.rid}: prompt+gen "
                             f"{req.total_len()} exceeds max_len "
                             f"{self.max_len}")
        try:
            self.scheduler.submit(req)
        except AdmissionRejected:
            self.metrics.on_reject()
            raise
        self._next_rid += 1
        self._requests[req.rid] = req
        self.metrics.on_submit(req.rid, self._step_no)
        return req.rid

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or resident request; False if unknown or
        already terminal (idempotent)."""
        req = self._requests.get(rid)
        if req is None or req.state in TERMINAL:
            return False
        if req.state == QUEUED:
            self.scheduler.remove_queued(req, CANCELLED)
        else:
            self.scheduler.retire(req, state=CANCELLED)
            self._evict(req)
        self.metrics.on_terminal(rid, CANCELLED)
        return True

    def drain(self, *, cancel_queued: bool = True) -> dict:
        """Admit nothing new, let resident requests finish, and return the
        final summary (queued requests are cancelled by default)."""
        if cancel_queued:
            for req in list(self._requests.values()):
                if req.state == QUEUED:
                    self.cancel(req.rid)
        self._draining = True
        try:
            budget = 8 * (self.max_len + 1) * max(1, self.scheduler.resident)
            while self.scheduler.resident > 0:
                self.step()
                budget -= 1
                if budget < 0:
                    return self.summary(stalled=True)
        finally:
            self._draining = False
        if cancel_queued:
            for req in list(self._requests.values()):
                if req.state == QUEUED:
                    self.cancel(req.rid)
        return self.summary()

    @torch.no_grad()
    def warmup(self) -> dict:
        """One prefill through every bucket and one admission + decode
        round, then reset all request state.  Returns the kernel launch
        counters after warmup."""
        for b in self.buckets:
            self._prefill(np.zeros((b,), np.int32))
        if self.max_len >= 3:
            plen = min(self.buckets[0], self.max_len - 2)
            self.submit(np.zeros((plen,), np.int32), 2)
            guard = 8 * (self.max_len + len(self.buckets))
            for _ in range(guard):
                if not self.scheduler.has_work():
                    break
                self.step()
        if self.scheduler.has_work():
            raise RuntimeError("warmup trace did not drain")
        self.reset()
        return kernel_launches()

    def reset(self) -> None:
        """Drop all request state; keep the model."""
        if self.scheduler.resident or self.scheduler.has_work():
            raise RuntimeError("reset with in-flight requests")
        self.pool = SlotPool(self.cfg, self.pool.max_slots, self.max_len,
                             quantized=self.quantized, device=self.device)
        self.scheduler = Scheduler(
            self.pool.max_slots, bytes_per_slot=self.pool.bytes_per_slot(),
            max_prefill_per_step=self.scheduler.max_prefill_per_step,
            max_queue=self.scheduler.max_queue)
        self.metrics = ServeMetrics()
        self._gen.manual_seed(self._seed)
        self._step_no = 0
        self._next_rid = 0
        self._draining = False
        self.n_prefills = 0
        self.n_decode_rounds = 0
        self._slot_req.clear()
        self._requests.clear()
        self._requests_done.clear()
        self._tokens_dev.zero_()
        self._active_dev.zero_()
        self._active_buf[:] = False

    # -- engine internals --------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt_len {n} exceeds largest bucket")

    def _prefill(self, prompt: np.ndarray):
        """Batch-1 prefill of ``prompt`` padded to its bucket -> (last valid
        logits (1, V), request cache grown to max_len)."""
        plen = len(prompt)
        padded = np.zeros((1, self._bucket_for(plen)), np.int32)
        padded[0, :plen] = prompt
        tokens = torch.from_numpy(padded).to(self.device)
        logits, aux = transformer.forward(
            self.model, self.cfg, {"tokens": tokens}, policy=self.policy,
            build_cache=True, cache_quantized=self.quantized)
        self.n_prefills += 1
        # last VALID position: padded suffix logits are garbage by contract
        return logits[:, plen - 1], transformer.grow_cache(aux["cache"],
                                                           self.max_len)

    def _decode(self) -> torch.Tensor:
        """One decode round over the pool with the fused health sentinel;
        returns the new (max_slots,) token buffer (-1 = tripped slot)."""
        cache = self.pool.cache
        pos_before = cache["pos"]
        logits, self.pool.cache = transformer.decode_step(
            self.model, self.cfg, cache, self._tokens_dev,
            policy=self.policy, quantized=self.quantized,
            kvq_splits=self.kv_splits, active=self._active_dev)
        self.n_decode_rounds += 1
        sampled = self._sampler(logits, self._gen)
        healthy = (torch.isfinite(logits).all(dim=-1) & (sampled >= 0)
                   & (sampled < self.cfg.vocab) & (pos_before > 0))
        tripped = torch.full_like(sampled, -1)
        return torch.where(self._active_dev & healthy, sampled,
                           torch.where(self._active_dev, tripped,
                                       self._tokens_dev))

    def _evict(self, req: Request) -> None:
        """Release a resident request's slot and device state."""
        self.pool.free(req.slot)
        self._active_buf[req.slot] = False
        self._active_dev[req.slot] = False
        del self._slot_req[req.slot]
        req.slot = None

    def _emit(self, req: Request, tok: int) -> None:
        """Record one sampled token; retire the request when finished."""
        req.tokens.append(tok)
        self.metrics.on_token(req.rid, self._step_no)
        hit_eos = req.eos_id is not None and tok == req.eos_id
        if hit_eos or len(req.tokens) >= req.max_new_tokens:
            self.scheduler.retire(req)
            self.metrics.on_done(req.rid)
            self._evict(req)
            self._requests_done.append(req)

    def _replay_prompt(self, req: Request) -> np.ndarray:
        """Prompt + already-emitted healthy tokens: the replay input."""
        if not req.tokens:
            return req.prompt
        return np.concatenate([req.prompt,
                               np.asarray(req.tokens, np.int32)])

    def _fault(self, req: Request) -> None:
        """The sentinel tripped on ``req``'s slot: quarantine the row,
        audit the pool, then replay or fail the request.  The faulted
        step's token is never emitted."""
        slot = req.slot
        self.metrics.on_fault(req.rid)
        self.pool.quarantine(slot)
        self._active_buf[slot] = False
        self._active_dev[slot] = False
        del self._slot_req[slot]
        req.slot = None
        self.pool.audit()
        self.pool.release_quarantined()

        reason = None
        if req.retries >= self.max_retries:
            reason = (f"retry budget exhausted "
                      f"({req.retries}/{self.max_retries})")
        elif len(self._replay_prompt(req)) > self.buckets[-1]:
            reason = (f"replay prompt {len(self._replay_prompt(req))} "
                      f"exceeds largest bucket {self.buckets[-1]}")
        if reason is not None:
            self.scheduler.retire(req, state=FAILED)
            req.fail_reason = reason
            self.metrics.on_terminal(req.rid, FAILED)
            return
        req.retries += 1
        self.scheduler.requeue(
            req, self._step_no + 1 + RETRY_BACKOFF_STEPS * req.retries)
        self.metrics.on_retry(req.rid)

    @torch.no_grad()
    def step(self) -> None:
        """Deadline shedding + admissions (bounded prefills) + one decode
        round with the fused health sentinel."""
        hook = self.hooks.get("pre_step")
        if hook is not None:
            hook(self)
        for req in self.scheduler.shed_expired(self._step_no):
            self.metrics.on_terminal(req.rid, req.state)

        admitted = [] if self._draining else \
            self.scheduler.pop_admissible(self.pool.free_slots, self._step_no)
        scatter_ok = self.hooks.get("scatter_filter")
        for req in admitted:
            slot = self.pool.alloc()
            if slot is None:
                raise RuntimeError("admitted a request with no free slot")
            prompt = self._replay_prompt(req)   # == req.prompt first time
            logits, req_cache = self._prefill(prompt)
            if scatter_ok is None or scatter_ok(self, req, slot):
                scatter_request(self.pool.cache, req_cache, slot, len(prompt))
            tok = int(self._sampler(logits, self._gen)[0])
            req.state = DECODE
            req.slot = slot
            self._slot_req[slot] = req
            self._tokens_dev[slot] = tok
            self._active_dev[slot] = True
            self._active_buf[slot] = True
            self._emit(req, tok)          # first token: the TTFT sample

        if self._active_buf.any():
            hook = self.hooks.get("pre_decode")
            if hook is not None:
                hook(self)
            live = np.nonzero(self._active_buf)[0]      # snapshot pre-emit
            self._tokens_dev = self._decode()
            # one host sync: the sentinel verdict is the token sign
            toks = self._tokens_dev.cpu().numpy()
            for slot in live:
                req = self._slot_req[int(slot)]
                if toks[slot] >= 0:
                    self._emit(req, int(toks[slot]))
                else:
                    self._fault(req)

        self.metrics.on_step(self._step_no, self.scheduler.queue_depth,
                             self.pool.occupancy)
        self._step_no += 1

    def summary(self, *, stalled: bool = False) -> dict:
        """Metrics summary + scheduler/pool diagnostics + kernel counters."""
        out = self.metrics.summary(max_slots=self.pool.max_slots)
        out["stalled"] = stalled
        out["diagnostics"] = {
            "step_no": self._step_no,
            "queue_depth": self.scheduler.queue_depth,
            "resident": self.scheduler.resident,
            "state_counts": self.scheduler.state_counts(),
            "prefills": self.n_prefills,
            "decode_rounds": self.n_decode_rounds,
            "kernel_launches": kernel_launches(),
            "pool": {"occupancy": self.pool.occupancy,
                     "free": self.pool.free_slots,
                     "quarantined": self.pool.quarantined,
                     "allocs": self.pool.allocs, "frees": self.pool.frees,
                     "quarantines": self.pool.quarantines},
        }
        return out

    def run(self, trace: Sequence[TraceRequest]) -> dict:
        """Drive a trace to completion; returns the metrics summary.
        Arrivals are step-indexed; idle gaps fast-forward; a run past its
        step budget returns a partial summary flagged ``stalled``."""
        pending = sorted(trace, key=lambda r: r.arrival_step)
        i = 0
        budget = (sum((r.max_new_tokens + 2) * (self.max_retries + 1)
                      for r in pending)
                  + (pending[-1].arrival_step if pending else 0) + 16)
        while i < len(pending) or self.scheduler.has_work():
            while (i < len(pending)
                   and pending[i].arrival_step <= self._step_no):
                r = pending[i]
                try:
                    self.submit(r.prompt, r.max_new_tokens)
                except AdmissionRejected:
                    pass                  # backpressure: counted, shed
                i += 1
            if not self.scheduler.has_work() and i < len(pending):
                self._step_no = pending[i].arrival_step   # fast-forward idle
                continue
            self.step()
            budget -= 1
            if budget < 0:
                return self.summary(stalled=True)
        return self.summary()
