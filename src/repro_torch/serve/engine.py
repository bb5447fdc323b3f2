"""Continuous-batching serve engine on one device (counterpart of
``repro.serve.engine``).

One engine step = deadline shedding + (bounded) admissions + one decode
round:

* admission: FCFS requests claim a pool slot, prefill at batch 1 over a
  power-of-two prompt BUCKET (padded; under causal attention the padded
  suffix never touches the prefix, so the cache rows and the last valid
  logit equal an unpadded prefill's), are copied into the slot, and sample
  their first token (TTFT).  On the card the prefill runs the flash
  kernel once per layer (under M-RoPE, qwen2-vl, the plain attention, as
  in the reference);
* decode: one step over the whole pool at ``(max_slots, max_len)``;
  occupancy lives in the per-slot ``pos`` lengths and the active mask, and
  on the card every layer runs the split-K int8 decode kernel, whose
  length-aware loop never loads the padded tail of a slot (a sliding
  window's band goes to the kernel's dense-bias entry point instead).

Fault tolerance, as in the JAX engine: a health sentinel rides in the
sampled token (a tripped slot yields -1: non-finite logits, a token
outside the vocab, or a slot whose prompt was never scattered), the slot
is quarantined, the pool audited, and the request replays from its prompt
plus its healthy tokens with a bounded retry budget.  Deadlines, a
bounded queue, ``cancel`` and ``drain`` work as there.

Instead of ``compile_counts`` (PyTorch runs eagerly and compiles nothing)
the engine reports the kernels' launch counters
(:func:`kernel_launches`) and its own prefill / decode-round counts, so a
run shows that its main path went through the kernels.  With
``mem_budget_bytes`` the slot count is clamped to what the budget admits
(``plan.serve_capacity_report``, the JAX engine's arithmetic) and the
scheduler admits against the same bytes.

Sampling at ``temperature > 0`` is one Gumbel-max pass over the batch
(``sampling.sampling_scores``) whose row keys come from one of two
schedules, as in JAX: ``sampler_keys="step"`` (the default) folds the
engine's sampler-call counter and the row, deterministic for a fixed
engine; ``sampler_keys="request"`` folds each row's request identity and
a per-slot draw counter, both on the device, so a trajectory does not
depend on placement (the fleet's mode).  The fleet surface, as in JAX:
``submit(front=, key_id=, emitted=)`` admits a request migrating in
through the replay path (prefill over prompt + emitted, first new draw
at ``len(emitted)``); ``evict_request`` moves a request out (``cancel``
is its ``CANCELLED`` case); ``request_states`` is the host-side view a
worker ships.  A
``tracer`` (``repro_torch.obs.Tracer``) records req / queue / prefill /
decode / step spans on the host; an untraced engine pays nothing.

Over a ``launch/mesh.py`` ``Mesh`` (``mesh=``; the ranks joined in a
process group, every rank running the same engine on the same requests)
the model is this rank's block of the weights and the pool this rank's
block of the cache: the model axis splits the KV heads, or the cache's
sequence where the heads do not divide it
(``sharding.serve_kv_shard``); the data axis replicates (every data row
of ranks serves the whole trace, as the reference's engine replicates
its slot axis over data).  The prefill's and the decode's logits are
gathered whole on every rank, so every host decision -- admission,
sampling, the sentinel, retries, eviction -- is the same on every rank,
and so are the streams.  The memory budget is per device.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.mixed_precision import get_policy
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.kvq import ops as kvq_ops
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serve import sampling
from repro_torch.serve.cache_pool import SlotPool, scatter_request
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import (CANCELLED, DECODE, FAILED,
                                         MIGRATED, QUEUED, TERMINAL,
                                         AdmissionRejected, Request,
                                         Scheduler)
from repro_torch.serve.trace import TraceRequest


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
    GQA int8 cache layout and a uniform window schedule (no per-layer
    overrides), and no encoder, as in the JAX package.  qwen2-vl is
    eligible: its prefill takes ``forward``'s default (3, B, S) positions
    (the plain attention, as the reference's M-RoPE path) and each slot's
    decode turns its one position on all three M-RoPE streams."""
    return (cfg.mixer == "attn" and cfg.mla is None and cfg.encoder is None
            and not cfg.global_layers)


def _check_shard(model, cfg: ModelConfig, mesh, max_len: int) -> None:
    """Refuse a mesh the engine cannot serve, and a model that is not this
    rank's block (``transformer.param_shard_specs``) on it."""
    n = mesh.shape["model"]
    if shd.serve_kv_shard(mesh, cfg.n_kv, max_len) == "none":
        raise ValueError(
            f"ServeEngine: neither the {cfg.n_kv} KV heads nor max_len "
            f"{max_len} split over a model axis of {n}")
    named = {k: tuple(p.shape) for k, p in model.named_parameters()}
    full = {k: tuple(p.shape) for k, p in transformer.init_params(
        cfg, device="meta").named_parameters()}
    specs = transformer.param_shard_specs(cfg, full, mesh)
    bad = [k for k in full
           if named.get(k) != shd.local_shape(full[k], specs[k], mesh)]
    if bad:
        raise ValueError(
            f"ServeEngine: the model is not this rank's block on {mesh} "
            f"(build it with init_params / load_jax_params(mesh=)): "
            f"{bad[:3]}")


def kernel_launches() -> dict:
    """Launch counters of the serving path's CUDA kernels (the forward's
    FMA and tensor-core designs apart, and the decode kernel's lengths and
    dense-bias entry points)."""
    return {"flash_fwd": flash_ops.KERNEL.launches,
            "flash_fwd_sm90": flash_ops.FWD_SM90.launches,
            "flash_decode": kvq_ops.KERNEL.launches,
            "flash_decode_bias": kvq_ops.BIAS_KERNEL.launches}


class ServeEngine:
    """Slot-pooled continuous-batching engine (see module docstring)."""

    def __init__(self, model: transformer.Transformer, cfg: ModelConfig, *,
                 max_slots: int, max_len: int,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 policy_name: str = "bf16", quantized: bool = True,
                 kv_splits: int = 1, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0,
                 max_prefill_per_step: int = 1,
                 mem_budget_bytes: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 deadline_steps: Optional[int] = None,
                 max_retries: int = 2, retry_backoff_steps: int = 1,
                 sampler_keys: str = "step", sink=None, mesh=None):
        if not supports(cfg):
            raise NotImplementedError(
                "ServeEngine needs a GQA attention arch with a full-causal "
                "uniform schedule (no MLA latents, SSM state, encoder "
                "cross-attention or per-layer window overrides)")
        if max_retries < 0 or retry_backoff_steps < 0:
            raise ValueError("ServeEngine: max_retries and "
                             "retry_backoff_steps must be >= 0")
        if sampler_keys not in ("step", "request"):
            raise ValueError(f"ServeEngine: sampler_keys must be 'step' or "
                             f"'request', got {sampler_keys!r}")
        self.sampler_keys = sampler_keys
        self.cfg = cfg
        self.max_len = max_len
        self.quantized = quantized
        self.kv_splits = kv_splits
        self.deadline_steps = deadline_steps
        self.max_retries = max_retries
        self.retry_backoff_steps = retry_backoff_steps
        self.temperature, self.top_k = float(temperature), int(top_k)
        #: host-side interception points ("pre_step", "pre_decode",
        #: "scatter_filter") -- the fault-injection seam -- and
        #: "post_logits" (engine, logits, scores, rows), called at every
        #: sampling with the (B, V) logits, the scores whose argmax is the
        #: token, and ``{row: Request}`` for the rows that hold requests
        self.hooks: dict[str, Callable] = {}
        self._tracer = None               # repro_torch.obs.Tracer via .tracer
        self.policy = get_policy(policy_name)
        self.mesh = mesh
        if mesh is not None and mesh.shape.get("model", 1) > 1:
            _check_shard(model, cfg, mesh, max_len)
        # the one cast to the compute dtype (a no-op for a model built in it)
        self.model = model.cast_to_compute(self.policy)
        self.device = self.model.embed.device
        self.capacity_report = None
        if mem_budget_bytes is not None:
            from repro_torch import plan as plan_mod
            # with a mesh the budget means bytes PER DEVICE
            self.capacity_report = plan_mod.serve_capacity_report(
                cfg, max_len, mem_budget_bytes, quantized=quantized,
                mesh=mesh)
            cap = self.capacity_report["max_slots"]
            if cap < 1:
                raise ValueError(
                    f"ServeEngine: memory budget {mem_budget_bytes} admits "
                    f"0 slots at max_len={max_len} "
                    f"({self.capacity_report['bytes_per_slot_per_device']} "
                    f"B/slot/device)")
            max_slots = min(max_slots, cap)
        self.mem_budget_bytes = mem_budget_bytes
        self.pool = SlotPool(cfg, max_slots, max_len, quantized=quantized,
                             device=self.device, mesh=mesh)
        self.scheduler = Scheduler(
            max_slots, bytes_per_slot=self.pool.bytes_per_slot_per_device(),
            byte_budget=mem_budget_bytes,
            max_prefill_per_step=max_prefill_per_step, max_queue=max_queue)
        self.metrics = ServeMetrics(sink=sink)
        self.buckets = tuple(sorted(prompt_buckets
                                    if prompt_buckets is not None
                                    else default_buckets(max_len)))
        if self.buckets[-1] > max_len:
            raise ValueError(f"prompt bucket {self.buckets[-1]} exceeds "
                             f"max_len {max_len}")
        self._seed = seed
        self._draws = 0                   # "step" keys: sampler calls so far
        self._step_no = 0
        self._next_rid = 0
        self._draining = False
        self.n_prefills = 0
        self.n_decode_rounds = 0
        self._slot_req: dict[int, Request] = {}
        self._requests: dict[int, Request] = {}            # every rid ever
        self._requests_done: list[Request] = []
        zeros = functools.partial(torch.zeros, (max_slots,),
                                  device=self.device)
        self._tokens_dev = zeros(dtype=torch.int32)
        self._active_dev = zeros(dtype=torch.bool)
        # "request" keys: each slot's request identity and next draw index
        self._kids_dev = zeros(dtype=torch.int64)
        self._draws_dev = zeros(dtype=torch.int64)
        self._active_buf = np.zeros((max_slots,), bool)    # host mirror

    # -- public API --------------------------------------------------------
    @property
    def step_no(self) -> int:
        return self._step_no

    @property
    def tracer(self):
        """``repro_torch.obs.Tracer``, or None (tracing off, the default).
        Every span is emitted on the host and guarded on this being set,
        so the untraced path pays nothing.  Attach after ``warmup()`` (the
        warmup probe would otherwise leave a phantom rid-0 trace)."""
        return self._tracer

    @tracer.setter
    def tracer(self, t) -> None:
        self._tracer = t
        self.scheduler.tracer = t         # queue-wait spans live there

    def _end_req_span(self, req: Request, state: str) -> None:
        """Close a request's open decode + root spans at terminal time."""
        if self._tracer is not None:
            self._tracer.end(req.span_ids.pop("decode", None), state=state)
            self._tracer.end(req.span_ids.pop("req", None), state=state,
                             tokens=len(req.tokens))

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None,
               arrival_step: Optional[int] = None,
               deadline_steps: Optional[int] = None,
               front: bool = False, key_id: Optional[int] = None,
               emitted: Optional[Sequence[int]] = None) -> int:
        """Queue a request; returns its rid.  FCFS from here on.

        Raises :class:`AdmissionRejected` when the bounded queue is full.
        ``deadline_steps`` is a queue TTL in engine steps (None: the
        engine's default).  ``front`` joins at the queue HEAD (the
        router's migration path); ``key_id`` overrides the sampler-key
        identity in ``sampler_keys="request"`` mode (the router passes the
        fleet-global id); ``emitted`` seeds the healthy tokens already
        generated for a request migrating in: admission then rides the
        replay path (prefill over prompt + emitted, first new draw index
        ``len(emitted)``), so the continuation is token-exact under greedy
        and key-exact in "request" mode."""
        prompt = np.asarray(prompt, np.int32)
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      arrival_step=(self._step_no if arrival_step is None
                                    else arrival_step),
                      eos_id=eos_id,
                      deadline_steps=(deadline_steps
                                      if deadline_steps is not None
                                      else self.deadline_steps),
                      key_id=key_id)
        if emitted:
            if len(emitted) >= max_new_tokens:
                raise ValueError(f"request {req.rid}: emitted prefix "
                                 f"{len(emitted)} leaves no tokens to "
                                 f"generate (max_new_tokens "
                                 f"{max_new_tokens})")
            req.tokens = [int(t) for t in emitted]
        if req.prompt_len + len(req.tokens) > self.buckets[-1]:
            raise ValueError(f"request {req.rid}: prompt_len "
                             f"{req.prompt_len}+{len(req.tokens)} emitted "
                             f"exceeds largest bucket {self.buckets[-1]}")
        if req.total_len() > self.max_len:
            raise ValueError(f"request {req.rid}: prompt+gen "
                             f"{req.total_len()} exceeds max_len "
                             f"{self.max_len}")
        if self._tracer is not None:
            req.span_ids["req"] = self._tracer.begin(
                "req", trace=self._kid(req), rid=req.rid,
                prompt_len=req.prompt_len, max_new_tokens=max_new_tokens,
                replay=bool(emitted))
        try:
            self.scheduler.submit(req, front=front)
        except AdmissionRejected:
            self.metrics.on_reject()
            if self._tracer is not None:
                self._tracer.end(req.span_ids.pop("req", None),
                                 state="REJECTED", tokens=0)
            raise
        self._next_rid += 1
        self._requests[req.rid] = req
        self.metrics.on_submit(req.rid, self._step_no)
        return req.rid

    def evict_request(self, rid: int,
                      state: str = MIGRATED) -> Optional[Request]:
        """Move a queued or resident request into a terminal state and
        return it (None if unknown or already terminal).  The router's
        migration path: the request's ``tokens`` are its healthy emitted
        prefix, the replay input on another replica.  A resident
        request's slot goes straight back to the pool (the next scatter
        overwrites its rows)."""
        req = self._requests.get(rid)
        if req is None or req.state in TERMINAL:
            return None
        if req.state == QUEUED:
            self.scheduler.remove_queued(req, state)
        else:
            self.scheduler.retire(req, state=state)
            self._evict(req)
        self.metrics.on_terminal(rid, state)
        self._end_req_span(req, state)
        return req

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or resident request; False if unknown or
        already terminal (idempotent)."""
        return self.evict_request(rid, CANCELLED) is not None

    def drain(self, *, cancel_queued: bool = True,
              max_steps: Optional[int] = None) -> dict:
        """Admit nothing new, let resident requests finish, and return the
        final summary (queued requests are cancelled by default)."""
        if cancel_queued:
            for req in list(self._requests.values()):
                if req.state == QUEUED:
                    self.cancel(req.rid)
        self._draining = True
        try:
            budget = max_steps if max_steps is not None else \
                8 * (self.max_len + 1) * max(1, self.scheduler.resident)
            while self.scheduler.resident > 0:
                self.step()
                budget -= 1
                if budget < 0:
                    return self.summary(stalled=True)
        finally:
            self._draining = False
        if cancel_queued:
            # a fault mid-drain can requeue a replay; it cannot be admitted
            # while draining, so cancel it rather than strand it
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
                             quantized=self.quantized, device=self.device,
                             mesh=self.mesh)
        self.scheduler = Scheduler(
            self.pool.max_slots,
            bytes_per_slot=self.pool.bytes_per_slot_per_device(),
            byte_budget=self.mem_budget_bytes,
            max_prefill_per_step=self.scheduler.max_prefill_per_step,
            max_queue=self.scheduler.max_queue)
        self.scheduler.tracer = self._tracer
        self.metrics = ServeMetrics(sink=self.metrics.sink,
                                    replica=self.metrics.replica)
        self._draws = 0
        self._step_no = 0
        self._next_rid = 0
        self._draining = False
        self.n_prefills = 0
        self.n_decode_rounds = 0
        self._slot_req.clear()
        self._requests.clear()
        self._requests_done.clear()
        for buf in (self._tokens_dev, self._active_dev, self._kids_dev,
                    self._draws_dev):
            buf.zero_()
        self._active_buf[:] = False

    # -- engine internals --------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt_len {n} exceeds largest bucket")

    def _kid(self, req: Request) -> int:
        """The request's sampler-key identity ("request" mode): the
        fleet-global id if the router set one, else the local rid."""
        return req.key_id if req.key_id is not None else req.rid

    def _step_keys(self, rows: torch.Tensor) -> torch.Tensor:
        """"step" mode: the keys of this sampler call's ``rows``."""
        self._draws += 1
        return sampling.fold_request_key(self._seed, self._draws - 1, rows)

    def _sample(self, logits: torch.Tensor, keys,
                rows: dict) -> torch.Tensor:
        """(B, V) logits -> (B,) int32 tokens: argmax of the sampling
        scores (the logits themselves when greedy)."""
        scores = sampling.sampling_scores(logits, keys,
                                          temperature=self.temperature,
                                          top_k=self.top_k)
        hook = self.hooks.get("post_logits")
        if hook is not None:
            hook(self, logits, scores, rows)
        return scores.argmax(dim=-1).to(torch.int32)

    def _first_token(self, req: Request, logits: torch.Tensor) -> int:
        """Sample a request's first token after (re-)prefill.  In
        "request" mode it draws at index ``len(req.tokens)`` of the
        request's own keys, as its original placement would have."""
        keys = None
        if self.temperature > 0.0 and self.sampler_keys == "step":
            keys = self._step_keys(torch.zeros((1,), dtype=torch.int64,
                                               device=self.device))
        elif self.temperature > 0.0:
            keys = torch.tensor([sampling.fold_request_key(
                self._seed, self._kid(req), len(req.tokens))],
                dtype=torch.int64, device=self.device)
        return int(self._sample(logits, keys, {0: req})[0])

    def _prefill(self, prompt: np.ndarray):
        """Batch-1 prefill of ``prompt`` padded to its bucket -> (last valid
        logits (1, V), request cache at the bucket's length, bucket).  Only
        the last valid position goes through the head (the padded
        suffix's logits are garbage by contract); the pool takes the cache
        by global position (``scatter_request(seq_offset=)``)."""
        plen = len(prompt)
        b = self._bucket_for(plen)
        padded = np.zeros((1, b), np.int32)
        padded[0, :plen] = prompt
        tokens = torch.from_numpy(padded).to(self.device)
        x, aux = transformer.forward(
            self.model, self.cfg, {"tokens": tokens}, policy=self.policy,
            build_cache=True, cache_quantized=self.quantized,
            return_hidden=True, mesh=self.mesh)
        self.n_prefills += 1
        return (transformer.head_logits(self.model, self.cfg,
                                        x[:, plen - 1], self.policy,
                                        self.mesh), aux["cache"], b)

    def _decode(self) -> torch.Tensor:
        """One decode round over the pool with the fused health sentinel;
        returns the new (max_slots,) token buffer (-1 = tripped slot)."""
        cache = self.pool.cache
        pos_before = cache["pos"]
        logits, self.pool.cache = transformer.decode_step(
            self.model, self.cfg, cache, self._tokens_dev,
            policy=self.policy, quantized=self.quantized,
            kvq_splits=self.kv_splits, active=self._active_dev,
            mesh=self.mesh)
        self.n_decode_rounds += 1
        keys = None                       # greedy: no keys
        if self.temperature > 0.0 and self.sampler_keys == "step":
            keys = self._step_keys(torch.arange(
                logits.shape[0], dtype=torch.int64, device=self.device))
        elif self.temperature > 0.0:
            # each row folds its own key from its request identity and
            # draw counter, both on the device: no host traffic
            keys = sampling.fold_request_key(self._seed, self._kids_dev,
                                             self._draws_dev)
            self._draws_dev += self._active_dev.to(torch.int64)
        sampled = self._sample(logits, keys, self._slot_req)
        healthy = (torch.isfinite(logits).all(dim=-1) & (sampled >= 0)
                   & (sampled < self.cfg.vocab) & (pos_before > 0))
        tripped = torch.full_like(sampled, -1)
        return torch.where(self._active_dev & healthy, sampled,
                           torch.where(self._active_dev, tripped,
                                       self._tokens_dev))

    def _release_slot(self, slot: int) -> None:
        """Deactivate ``slot`` and forget its request (the pool transition
        is the caller's: free or quarantine)."""
        self._active_buf[slot] = False
        self._active_dev[slot] = False
        del self._slot_req[slot]

    def _evict(self, req: Request) -> None:
        """Release a resident request's slot and device state."""
        self.pool.free(req.slot)
        self._release_slot(req.slot)
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
            self._end_req_span(req, req.state)

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
        if self._tracer is not None:
            self._tracer.end(req.span_ids.pop("decode", None), state="FAULT",
                             fault=True)
        self.pool.quarantine(slot)
        self._release_slot(slot)
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
            self._end_req_span(req, FAILED)
            return
        req.retries += 1
        # backoff: the replay waits retries * backoff steps at the head of
        # the line before re-prefilling
        self.scheduler.requeue(
            req, self._step_no + 1 + self.retry_backoff_steps * req.retries)
        self.metrics.on_retry(req.rid)

    @torch.no_grad()
    def step(self) -> None:
        """Deadline shedding + admissions (bounded prefills) + one decode
        round with the fused health sentinel."""
        hook = self.hooks.get("pre_step")
        if hook is not None:
            hook(self)
        tracer = self._tracer
        step_sid = None if tracer is None else \
            tracer.begin("step", step=self._step_no)
        for req in self.scheduler.shed_expired(self._step_no):
            self.metrics.on_terminal(req.rid, req.state)
            self._end_req_span(req, req.state)

        admitted = [] if self._draining else \
            self.scheduler.pop_admissible(self.pool.free_slots, self._step_no)
        scatter_ok = self.hooks.get("scatter_filter")
        for req in admitted:
            if tracer is not None:
                req.span_ids["prefill"] = tracer.begin(
                    "prefill", trace=self._kid(req),
                    parent=req.span_ids.get("req"))
            slot = self.pool.alloc()
            if slot is None:
                raise RuntimeError("admitted a request with no free slot")
            prompt = self._replay_prompt(req)   # == req.prompt first time
            logits, req_cache, bucket = self._prefill(prompt)
            if scatter_ok is None or scatter_ok(self, req, slot):
                scatter_request(self.pool.cache, req_cache, slot,
                                len(prompt), seq_offset=self.pool.seq_offset)
            tok = self._first_token(req, logits)
            req.state = DECODE
            req.slot = slot
            self._slot_req[slot] = req
            self._tokens_dev[slot] = tok
            self._active_dev[slot] = True
            if self.sampler_keys == "request":
                # identity + next draw index (the first token drew at
                # len(tokens); _emit appends it below)
                self._kids_dev[slot] = self._kid(req)
                self._draws_dev[slot] = len(req.tokens) + 1
            self._active_buf[slot] = True
            if tracer is not None:
                # prefill closes at the first sampled token (the TTFT
                # edge); decode residency is its own span from here
                tracer.end(req.span_ids.pop("prefill", None), bucket=bucket,
                           plen=len(prompt), slot=int(slot))
            self._emit(req, tok)          # first token: the TTFT sample
            if tracer is not None and req.state == DECODE:
                req.span_ids["decode"] = tracer.begin(
                    "decode", trace=self._kid(req),
                    parent=req.span_ids.get("req"), slot=int(slot))

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
        if tracer is not None:
            tracer.end(step_sid, admitted=len(admitted),
                       occupancy=self.pool.occupancy)
        self._step_no += 1

    def request_states(self) -> dict:
        """Host-side view of every request: ``rid -> {state, tokens,
        slot}``.  The subprocess worker's harvest payload and the
        journal's token-delta source."""
        return {rid: {"state": r.state, "tokens": list(r.tokens),
                      "slot": r.slot}
                for rid, r in self._requests.items()}

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
