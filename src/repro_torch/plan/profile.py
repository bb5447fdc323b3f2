"""Chain profiling: per-layer activation bytes + recompute FLOPs (the
sequential-chain part of ``repro.plan.profile``).

The planner (``solver``) needs, for every candidate checkpoint site, (a)
how many bytes the activation at that site occupies and (b) how expensive
the layers before it are to re-run.  This module gets both WITHOUT
allocating anything:

  * activation bytes by walking the layer functions on ``device="meta"``
    tensors (shapes and dtypes only, as ``jax.eval_shape`` does in the JAX
    package), so they equal the JAX package's byte for byte;
  * FLOPs analytically, from the shapes each layer's operators see
    (``torch.utils.flop_counter``: 2 per multiply-add of the convolutions
    and matrix products; 2 per output element for a layer with none).  The
    JAX package asks XLA's cost analysis, which has no counterpart here,
    so the FLOPs differ from its numbers.  ``plan_min_peak`` does not read
    them; ``plan_for_budget`` uses them only to order placements.

Two chain walkers cover the port's model stacks:

  * ``profile_resnet``      -- the explicit ``cnn.layer_fns`` list (the
    paper's own experiment models);
  * ``profile_transformer`` -- the block stack: bytes are the (B, S, D)
    carry, FLOPs are analytic per block (window-aware, so hybrid archs
    with sliding and global layers profile heterogeneously).

The transformer half budgets what the PORT dispatches, which is where the
packages differ: every attention layer goes through the flash op
(``models/attention.py``), whose kernels run 64 x 64 tiles
(``kernels/flash/ops.py`` ``BQ`` / ``BK``) over S rounded up to the tile,
masking the ragged tail, where the TPU kernels pad S to the 128-lane
block and run 128 x 128 tiles.  The byte arithmetic does not depend on
tiles and equals the JAX package's; the FLOP arithmetic equals it at the
JAX geometry (tile 128, S a multiple of 128) and equals the port's kernel
counters (``ops.expected_counts`` / ``expected_bwd_counts``) at its own.
Byte counts that need shapes (``serve_capacity_report``,
``profile_transformer``) come from ``device="meta"`` tensors, where the
JAX package uses ``jax.eval_shape``.

Per-device budgets (the reference's contract, ``--mem-budget-mb`` means
bytes per device): ``profile_transformer(model_shards=)`` and
``attn_resid_bytes(model_shards=)`` divide the attention residuals by the
head shards each device holds (the planner's microbatch is already
divided by DP, ``train_step.microbatch_specs``), and
``serve_capacity_report(mesh=)`` divides the K / V leaves by the shard
factor ``sharding.serve_kv_shard`` applies.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Callable, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.plan.solver import (RematPlan, budget_boundaries,
                                     min_peak_boundaries, plan_metrics)


@dataclasses.dataclass(frozen=True)
class ChainProfile:
    """Per-layer costs of a sequential chain (index i = layer i's output).

    ``resid_bytes`` (optional, same length) are per-layer BACKWARD
    residuals: bytes live while that layer's segment backward runs, beyond
    the checkpointable carry.  They widen the planner's live-set term but
    are never stored at checkpoint boundaries.
    """

    act_bytes: tuple[int, ...]
    flops: tuple[float, ...]
    labels: tuple[str, ...] = ()
    resid_bytes: tuple[int, ...] = ()

    def __post_init__(self):
        if len(self.act_bytes) != len(self.flops):
            raise ValueError("act_bytes and flops length mismatch")
        if self.resid_bytes and len(self.resid_bytes) != len(self.act_bytes):
            raise ValueError("resid_bytes and act_bytes length mismatch")

    @property
    def n_layers(self) -> int:
        return len(self.act_bytes)

    @property
    def resid_or_none(self) -> "tuple[int, ...] | None":
        """What the solvers take: None when no residuals were profiled."""
        return self.resid_bytes or None

    def total_bytes(self) -> int:
        return int(sum(self.act_bytes))

    def total_resid_bytes(self) -> int:
        return int(sum(self.resid_bytes))

    def total_flops(self) -> float:
        return float(sum(self.flops))

    def to_json(self) -> str:
        return json.dumps({"act_bytes": list(self.act_bytes),
                           "flops": list(self.flops),
                           "labels": list(self.labels),
                           "resid_bytes": list(self.resid_bytes)})

    @classmethod
    def from_json(cls, text: str) -> "ChainProfile":
        d = json.loads(text)
        return cls(tuple(d["act_bytes"]), tuple(d["flops"]),
                   tuple(d.get("labels", ())),
                   tuple(d.get("resid_bytes", ())))


def _meta(x: torch.Tensor) -> torch.Tensor:
    """A meta tensor of ``x``'s shape, strides and dtype."""
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device="meta")


# ---------------------------------------------------------------------------
# Chain walkers.
# ---------------------------------------------------------------------------
def profile_sequential(layer_fns: Sequence[Callable], x0: torch.Tensor,
                       labels: Sequence[str] = ()) -> ChainProfile:
    """Walk an explicit chain of tensor -> tensor layer functions on meta
    tensors; never allocates.  ``layer_fns`` must close over meta
    parameters (or none)."""
    x = _meta(x0)
    act, flops = [], []
    with torch.no_grad():
        for fn in layer_fns:
            with FlopCounterMode(display=False) as counter:
                x = fn(x)
            n = counter.get_total_flops()
            flops.append(float(n) if n > 0 else 2.0 * x.numel())
            act.append(x.numel() * x.element_size())
    return ChainProfile(tuple(act), tuple(flops),
                        tuple(labels) if labels else ())


def profile_resnet(params, cfg, image) -> ChainProfile:
    """Profile the ResNet layer list ``checkpoint_sequential`` consumes.
    ``image``: a tensor (any device, meta included) with the NHWC shape
    and dtype of the batch the chain will see."""
    from repro_torch.models import cnn
    fns = cnn.layer_fns({n: _meta(p) for n, p in params.items()}, cfg)
    labels = ["stem"] + [f"block{i}" for i in range(len(fns) - 2)] + ["head"]
    return profile_sequential(fns, image.permute(0, 3, 1, 2), labels)


def flash_training_eligible(cfg, s: int) -> bool:
    """Does the training forward dispatch attention to the flash op?

    Mirrors the port's gates: ``models/attention.py`` ``attn_block`` calls
    ``flash_ops.flash_attention`` (the kernels on the card, their plain
    versions on the CPU) for causal attention over 1-D positions, in every
    layer, windowed and global alike, at every head dim the port runs (160
    included).  So every attention or hybrid arch is eligible at every S
    but MLA, whose ``mla_block`` runs the plain ``gqa_attention``, and
    M-RoPE (qwen2-vl), whose (3, B, S) positions send ``attn_block`` to
    it: both as the reference's do (``repro/plan/profile.py:150``).  The
    JAX package also differs for ``cfg.global_layers`` (hymba), whose scan
    takes its jnp path with O(S^2) probabilities, and for head dims its
    Pallas kernel refuses (160), which fall back to its plain version.
    Whisper's encoder is outside the planner's chain, as in the
    reference."""
    del s                                   # the flash op takes any S
    return (cfg.mixer in ("attn", "hybrid") and cfg.mla is None
            and cfg.mrope_sections is None)


def attn_resid_bytes(cfg, b: int, s: int, dtype_bytes: int = 2,
                     flash_resid_bytes: "int | None" = None, *,
                     ctx: "int | None" = None,
                     model_shards: int = 1) -> int:
    """Backward-residual bytes of one attention layer.

    Under the flash op it keeps q / o per query head and k / v per KV
    head alive between forward and backward, and the two f32 softmax stat
    rows (m, l) per head; scores are recomputed tile by tile in the
    backward.  ``flash_resid_bytes`` is the element width of the SAVED
    (q, k, v, o) under a ``Policy.flash_resid_dtype`` (default: the
    compute dtype's); (m, l) are f32 regardless, as the kernels' contract
    says.  MLA and M-RoPE, which the flash op does not take
    (:func:`flash_training_eligible`), are budgeted as the JAX package
    budgets its plain path: q / o and k / v at ``head_dim`` plus the f32
    probabilities, ``ctx`` keys a query row (default S).

    ``model_shards`` divides every per-head term when heads shard over
    the mesh's model axis: both head counts must divide it, the gate
    ``sharding.flash_shard_specs`` applies; otherwise the residuals stay
    whole, as the replicated fallback keeps them."""
    if cfg.mixer not in ("attn", "hybrid"):
        return 0
    ms = model_shards if (model_shards > 1
                          and cfg.n_heads % model_shards == 0
                          and cfg.n_kv % model_shards == 0) else 1
    heads = 2 * cfg.n_heads + 2 * cfg.n_kv
    if not flash_training_eligible(cfg, s):
        ctx = s if ctx is None else ctx
        qo_kv = heads * b * s * cfg.head_dim * dtype_bytes
        return (qo_kv + 4 * b * cfg.n_heads * s * ctx) // ms   # f32 probs
    rb = dtype_bytes if flash_resid_bytes is None else flash_resid_bytes
    qo_kv = heads * b * s * cfg.head_dim * rb
    return (qo_kv + 2 * 4 * b * cfg.n_heads * s) // ms     # f32 m, l rows


def _flash_tile_counts(cfg, s: int) -> "list[dict]":
    """Per-layer visited / dense tile-step counts of the flash grids, per
    head, on the geometry the port's kernels run: ``ops.BQ`` x ``ops.BK``
    tiles over S rounded up to the tile, keys masked at S.  These equal
    the kernels' counters (``ops.expected_counts`` /
    ``expected_bwd_counts``) by construction."""
    from repro_torch.kernels import tiling
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.models import transformer
    bq, bk = flash_ops.BQ, flash_ops.BK
    n = -(-s // bq) * bq
    return [tiling.tile_step_counts(n, bq=bq, bk=bk, causal=True, window=w,
                                    kv_len=s)
            for w in transformer.layer_windows(cfg)]


def flash_bwd_recompute_flops(cfg, b: int, s: int) -> tuple[float, ...]:
    """Per-layer extra FLOPs the flash backward spends recomputing scores.

    The dQ and dKV kernels both re-run the QK^T product from the saved
    stats, on the tiles their grids visit: ``2 * BQ * BK * D`` FLOPs per
    visited tile-step per (batch x head), summed over the dQ and dKV
    grids.  Zero where attention does not go through the flash op."""
    if not flash_training_eligible(cfg, s):
        return tuple(0.0 for _ in range(cfg.n_layers))
    bh = b * cfg.n_heads * cfg.head_dim
    return tuple(2.0 * bh * c["bq"] * c["bk"] * (c["dq"] + c["dkv"])
                 for c in _flash_tile_counts(cfg, s))


def flash_attn_flop_report(cfg, b: int, s: int) -> dict:
    """Dense-vs-visited attention FLOPs across the three flash grids.

    Counts every product each grid runs per visited tile-step -- forward
    (QK^T, PV: 4 BQ BK D), dQ (score recompute, dP, dS K: 6), dKV (score
    recompute, P^T dO, dP, dS^T Q: 8) -- against the same products on the
    dense nQ x nK rectangle a mask-blind grid runs."""
    if not flash_training_eligible(cfg, s):
        return {"eligible": False, "dense_flops": 0.0, "visited_flops": 0.0,
                "skip_frac": 0.0, "visited_tile_steps": 0,
                "dense_tile_steps": 0}
    bh = b * cfg.n_heads * cfg.head_dim
    dense = visited = 0.0
    vis_steps = dense_steps = 0
    for c in _flash_tile_counts(cfg, s):
        tile = bh * c["bq"] * c["bk"]
        visited += tile * (4.0 * c["fwd"] + 6.0 * c["dq"] + 8.0 * c["dkv"])
        dense += tile * (4.0 + 6.0 + 8.0) * c["dense"]
        vis_steps += c["fwd"] + c["dq"] + c["dkv"]
        dense_steps += 3 * c["dense"]
    return {"eligible": True, "dense_flops": dense, "visited_flops": visited,
            "skip_frac": 1.0 - (vis_steps / dense_steps if dense_steps
                                else 0.0),
            "visited_tile_steps": vis_steps, "dense_tile_steps": dense_steps}


def decode_tile_report(cfg, b: int, s: int, *, lengths=None, splits: int = 1,
                       block_s: int | None = None) -> dict:
    """Visited-vs-dense tile accounting for split-K int8 KV decode.

    Per layer, how many KV tile-steps the length-aware split-K decode
    executes against the dense per-(batch, KV head) sweep a length- and
    window-blind kernel over the full S-slot cache would pay, with the
    FLOPs and int8 cache bytes those tiles carry, from the same
    ``tiling.decode_tile_step_counts`` bounds as the JAX package.
    Windowed layers are budgeted at their rolling ``min(window, s)``
    buffer, and ``lengths`` clamp to it; ``lengths=None`` budgets a full
    cache."""
    from repro_torch.kernels import tiling
    from repro_torch.models import transformer
    zeros = {"eligible": False, "visited_tile_steps": 0,
             "dense_tile_steps": 0, "visited_flops": 0.0, "dense_flops": 0.0,
             "visited_kv_bytes": 0, "dense_kv_bytes": 0, "skip_frac": 0.0,
             "per_layer": []}
    if cfg.mixer not in ("attn", "hybrid") or cfg.mla is not None:
        return zeros                 # MLA / SSM caches are not the kvq layout
    if lengths is not None and len(lengths) != b:
        raise ValueError(f"decode_tile_report: {len(lengths)} lengths for "
                         f"batch {b} -- the visited/dense ratio would mix "
                         f"batch sizes")
    lens = [s] * b if lengths is None else [int(x) for x in lengths]
    hkv, g, d = cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.head_dim
    bs_kw = {} if block_s is None else {"block_s": block_s}
    # dense baseline: a sweep over a full S-slot single-tier cache, every
    # tile visited (no lengths, no rolling buffer)
    c_full = tiling.decode_tile_step_counts(s, None, **bs_kw)
    per_layer = []
    visited = dense = vis_fl = den_fl = vis_by = den_by = 0

    def tile_fl(bs_):       # QK^T (G,D)x(D,BS) + PV (G,BS)x(BS,D), per head
        return 4.0 * g * d * bs_ * hkv

    def tile_by(bs_):       # int8 K + V tiles + their f32 scales
        return hkv * (2 * bs_ * d + 2 * bs_ * 4)

    for w in transformer.layer_windows(cfg):
        s_l = s if w <= 0 else min(w, s)
        c = tiling.decode_tile_step_counts(
            s_l, [min(ln, s_l) for ln in lens], splits=splits, **bs_kw)
        vis, den = c["visited"], b * c_full["ns"]
        per_layer.append({"window": w, "cache_len": s_l, "bs": c["bs"],
                          "splits": c["splits"], "visited": vis,
                          "dense": den})
        visited += vis
        dense += den
        vis_fl += vis * tile_fl(c["bs"])
        den_fl += den * tile_fl(c_full["bs"])
        vis_by += vis * tile_by(c["bs"])
        den_by += den * tile_by(c_full["bs"])
    return {"eligible": True, "visited_tile_steps": visited,
            "dense_tile_steps": dense, "visited_flops": vis_fl,
            "dense_flops": den_fl, "visited_kv_bytes": vis_by,
            "dense_kv_bytes": den_by,
            "skip_frac": 1.0 - (visited / dense if dense else 0.0),
            "per_layer": per_layer}


def kv_cache_report(cfg, b: int, s: int) -> dict:
    """int8-vs-f32 KV-cache bytes at serve time, windowed layers sized at
    their rolling ``min(window, s)`` buffer.  int8 counts the deployed
    encoding (1 B an element of K and V plus two f32 scale rows a token);
    f32 is the un-encoded strawman."""
    from repro_torch.models import transformer
    if cfg.mixer not in ("attn", "hybrid") or cfg.mla is not None:
        return {"eligible": False, "int8_bytes": 0, "f32_bytes": 0,
                "ratio": 0.0}
    hkv, d = cfg.n_kv, cfg.head_dim
    int8 = f32 = 0
    for w in transformer.layer_windows(cfg):
        s_l = s if w <= 0 else min(w, s)
        tokens = b * hkv * s_l
        int8 += 2 * tokens * d + 2 * tokens * 4
        f32 += 2 * tokens * d * 4
    return {"eligible": True, "int8_bytes": int8, "f32_bytes": f32,
            "ratio": f32 / int8 if int8 else 0.0}


def serve_capacity_report(cfg, s_max: int, budget_bytes: int, *,
                          quantized: bool = True,
                          params_bytes: int = 0, mesh=None) -> dict:
    """Max resident request slots a serve-memory budget admits.

    The slot pool (``repro_torch.serve``) preallocates its decode cache at
    ``(max_slots, s_max)``, so capacity is ``(budget - params) //
    bytes_per_slot``.  ``bytes_per_slot`` is exact: every leaf
    ``transformer.init_cache`` makes at batch 1 (on ``device="meta"``)
    but ``pos``, i.e. what the pool allocates per slot;
    ``kv_int8_bytes_per_slot`` cross-references :func:`kv_cache_report`.

    With ``mesh`` (``launch/mesh.py`` ``Mesh``), ``budget_bytes`` means
    bytes per device: each K / V leaf divides by the shard factor
    ``sharding.serve_kv_shard`` applies on that mesh, giving
    ``bytes_per_slot_per_device``, and ``max_slots`` is what one device's
    budget admits (every device holds its slice of every slot).  Without
    a mesh ``bytes_per_slot_per_device`` equals ``bytes_per_slot``."""
    from repro_torch.models import transformer
    cache = transformer.init_cache(cfg, 1, s_max, quantized=quantized,
                                   device="meta")
    sizes = {k: x.numel() * x.element_size() for k, x in cache.items()
             if k != "pos"}
    bytes_per_slot = sum(sizes.values())
    shard, kv_mode, devices = 1, "none", 1
    if mesh is not None:
        from repro_torch.distributed import sharding
        devices = mesh.size
        kv_mode = sharding.serve_kv_shard(mesh, cfg.n_kv, s_max)
        if kv_mode != "none":
            shard = mesh.shape["model"]
    per_dev = sum(n // (shard if k in ("k", "v", "k_scale", "v_scale")
                        else 1) for k, n in sizes.items())
    kv_rep = kv_cache_report(cfg, 1, s_max)
    usable = max(0, int(budget_bytes) - int(params_bytes))
    return {
        "eligible": bytes_per_slot > 0,
        "bytes_per_slot": int(bytes_per_slot),
        "bytes_per_slot_per_device": int(per_dev),
        "kv_int8_bytes_per_slot": int(kv_rep["int8_bytes"]),
        "budget_bytes": int(budget_bytes),
        "params_bytes": int(params_bytes),
        "max_slots": (usable // per_dev) if per_dev else 0,
        "devices": int(devices),
        "model_shards": int(shard),
        "kv_shard": kv_mode,
        "s_max": int(s_max),
        "quantized": bool(quantized),
    }


def profile_transformer(cfg, batch_sds, *, dtype_bytes: int = 2,
                        flash_resid_bytes: "int | None" = None,
                        model_shards: int = 1) -> ChainProfile:
    """Profile the block stack: carry bytes and window-aware analytic
    FLOPs.

    ``batch_sds`` is the train input dict ({tokens: (B, S), ...}; tensors
    on any device, ``meta`` included: only shapes are read).  The
    checkpointable site between blocks is the (B, S, D) carry; per-block
    FLOPs are 2 x tokens x block parameters (the products) plus the
    attention scores, at the visited-tile count of the flash grids
    (causal about half the dense rectangle, a window about W/S), the
    source of heterogeneity for windowed / hybrid archs; MLA's and
    M-RoPE's at the dense (masked) score product their plain attention
    runs.
    ``resid_bytes`` carries the attention backward residuals
    (:func:`attn_resid_bytes`); ``flash_resid_bytes`` forwards a
    ``Policy.flash_resid_dtype`` width.  Block parameters are counted on
    a ``device="meta"`` model: an MoE block's are every expert's, as the
    JAX planner counts them (not the top-k a token reaches).

    ``model_shards`` (the mesh's TP width) makes the profile per device:
    ``batch_sds`` is already the per-device microbatch, the (B, S, D)
    carry is replicated over the model axis and stays whole, and the
    attention residuals divide by the head shards each device holds
    (:func:`attn_resid_bytes`)."""
    from repro_torch.models import transformer
    b, s = batch_sds["tokens"].shape
    carry_bytes = b * s * cfg.d_model * dtype_bytes
    model = transformer.init_params(cfg, 0, device="meta")
    per_block_params = sum(p.numel() for p in
                           model.blocks.parameters()) / cfg.n_layers

    windows = transformer.layer_windows(cfg)
    flash = flash_training_eligible(cfg, s)
    tile_counts = _flash_tile_counts(cfg, s) if flash else None
    act, flops, labels, resid = [], [], [], []
    for i, w in enumerate(windows):
        ctx = s if w == 0 else min(w, s)
        attn_flops = 0.0
        if flash:
            c = tile_counts[i]
            attn_flops = 4.0 * b * cfg.n_heads * cfg.head_dim \
                * c["bq"] * c["bk"] * c["fwd"]
        elif cfg.mixer in ("attn", "hybrid"):   # the plain path's scores
            attn_flops = 4.0 * b * s * ctx * cfg.n_heads * cfg.head_dim
        flops.append(2.0 * b * s * per_block_params + attn_flops)
        act.append(carry_bytes)
        resid.append(attn_resid_bytes(cfg, b, s, dtype_bytes,
                                      flash_resid_bytes=flash_resid_bytes,
                                      ctx=ctx, model_shards=model_shards))
        labels.append(f"block{i}" + ("" if w == 0 else f"@w{w}"))
    return ChainProfile(tuple(act), tuple(flops), tuple(labels),
                        tuple(resid))


# ---------------------------------------------------------------------------
# Profile -> plan.
# ---------------------------------------------------------------------------
def plan_min_peak(profile: ChainProfile, num_checkpoints: int,
                  policy: str = "full") -> RematPlan:
    """Dual solver: best placement of a fixed number of checkpoints."""
    bounds = min_peak_boundaries(profile.act_bytes, num_checkpoints,
                                 resid_bytes=profile.resid_or_none)
    return RematPlan(profile.n_layers, tuple(bounds), policy,
                     source=f"min_peak:k={num_checkpoints}")


def plan_for_budget(profile: ChainProfile, budget_bytes: float,
                    policy: str = "full") -> RematPlan:
    """Primal solver: min recompute FLOPs with peak bytes <= budget.

    An unsatisfiable budget yields the peak-minimal best-effort plan,
    tagged ``:infeasible`` in ``source`` AND warned about, so the violated
    constraint is never silent.
    """
    bounds, feasible = budget_boundaries(profile.act_bytes, profile.flops,
                                         budget_bytes,
                                         resid_bytes=profile.resid_or_none)
    tag = f"budget:{int(budget_bytes)}" + ("" if feasible else ":infeasible")
    if not feasible:
        peak = plan_metrics(profile.act_bytes, profile.flops, bounds,
                            resid_bytes=profile.resid_or_none)["peak_bytes"]
        warnings.warn(
            f"remat budget {budget_bytes/2**20:.1f} MiB is infeasible for "
            f"this chain; best-effort plan peaks at {peak/2**20:.1f} MiB "
            f"(min achievable)", stacklevel=2)
    return RematPlan(profile.n_layers, tuple(bounds), policy, source=tag)


def plan_report(profile: ChainProfile, plan: RematPlan) -> dict:
    """Human/JSON-facing summary of a plan against its profile."""
    m = plan_metrics(profile.act_bytes, profile.flops, plan.boundaries,
                     resid_bytes=profile.resid_or_none)
    return {
        "source": plan.source,
        "n_layers": plan.n_layers,
        "boundaries": list(plan.boundaries),
        "segment_sizes": plan.segment_sizes(),
        **m,
        "recompute_frac": (m["recompute_flops"] / profile.total_flops()
                           if profile.total_flops() else 0.0),
        "no_remat_bytes": profile.total_bytes(),
        "resid_bytes_total": profile.total_resid_bytes(),
    }
