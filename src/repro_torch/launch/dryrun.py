"""Multi-pod dry run (counterpart of ``repro.launch.dryrun``): trace every
(arch x shape) cell on the production meshes, with no card, and read the
roofline terms off the trace against the H100's constants.

No storage is allocated: each cell runs one step, at full depth, of the
port's own entry points (``make_train_step`` / ``make_serve_steps``) on
fake tensors (``torch._subclasses.fake_tensor.FakeTensorMode``), as rank 0
of a fake process group of the mesh's size (``torch.distributed``'s
"fake" backend: every collective is a no-op with the right shapes), with
every kernel wrapper on the route an H100 takes
(``core.device.trace_for_card``: the dispatcher ops' fakes in place of
the launches).  This proves, for (data 16, model 16) and (pod 2, data 16,
model 16), that the placement is coherent (every block divides, every
collective is legal on its group) and shows whether a rank's step fits in
an 80 GB card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--json out.json]

Result keys (per device: rank 0's step), and what the port measures under
each of the reference's names:
  hlo_gflops            FLOPs of the step, ``torch.utils.flop_counter``:
                        matmuls, convolutions and the kernel ops' formulas
                        (the products of the tiles the kernels visit, not
                        a dense S^2; a decode op counts a full cache);
                        elementwise work and reductions are not counted
  hlo_gbytes            operand + output bytes of every non-view op of
                        the trace, collectives aside: a gross upper bound
                        with no fusion credit, as XLA's "bytes accessed"
  collective_gbytes     per-device output bytes of every ``c10d`` op, at
                        the width it sends (f32 sums in f32); collectives
                        by op name under ``collectives``
  raw_uncorrected       the same three totals: eager tracing visits every
                        layer and microbatch, so no loop correction (the
                        reference's L=1 / L=2 probes) applies, and nothing
                        is widened on the CPU, so no ``_widened`` term
  bytes_per_device      the traced peak of live storages: weights,
                        moments, inputs or cache, activations, saved
                        tensors and gradients
  arg_bytes_per_device  what is resident before the step
  temp_bytes_per_device the difference
  compute_s, memory_s, collective_s, bottleneck, memory_ub_s,
  memory_lb_bytes, model_flops, useful_flops_frac
                        the reference's arithmetic, with PEAK_FLOPS,
                        HBM_BW and LINK_BW below
  lower_s, compile_s    seconds to build the step and its fake inputs,
                        and to trace it
  kernel_calls          the traced kernel calls by launch counter
                        (``build.Kernel.entry``, which names the route):
                        the twin of the kernels' ``launches`` on the card
  plan_* / attn_* / flash_* / kv_cache_* / decode_*
                        the port's planner (advisory, never fails a
                        cell); ``attn_backend`` is the flash forward's
                        route in the trace (``sm90`` / ``fma``), or
                        ``plain`` where no flash kernel ran

The link term is a floor, not an estimate: ``LINK_BW`` is one GPU's
NVLink 4 bandwidth in one direction, and an axis wider than an 8-GPU node
(the 16-wide model axis) crosses InfiniBand, several times slower.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import sys
import time
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.core import device as device_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import describe, make_production_mesh

# NVIDIA H100 SXM (per card)
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s: NVLink 4, one GPU, one direction

#: ``c10d`` ops by the reference's collective names; the first argument of
#: each is what it writes
_COLL_OPS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
}


def _tensors(obj) -> list:
    """Every tensor in ``obj``: nested dicts, lists, tuples, dataclasses
    and modules (their parameters and buffers)."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    walk(obj)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_VIEWS: dict = {}
_DEVICE = torch.ops.prim.device.default


def _is_view(func) -> bool:
    """Does ``func``'s first output alias an input without writing it?"""
    v = _VIEWS.get(func)
    if v is None:
        rets = func._schema.returns
        v = _VIEWS[func] = bool(rets) and rets[0].alias_info is not None \
            and not rets[0].alias_info.is_write
    return v


def _flat(x, out: list) -> list:
    """The tensors of an op's arguments or outputs (nested lists, tuples
    and dicts), appended to ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _flat(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _flat(v, out)
    return out


class StepTrace(TorchDispatchMode):
    """The counts of one step, op by op: each ``c10d`` collective's output
    bytes by name (:attr:`coll`), every other non-view op's operand and
    output bytes (:attr:`op_bytes`), and the live storages: those of
    ``resident`` (the step's arguments) from the start, each op's new
    outputs from the op on, each dropped when its storage dies
    (:attr:`resident_bytes`, :attr:`peak_bytes`).  Fake tensors and real
    ones alike."""

    def __init__(self, resident=()):
        super().__init__()
        self._live: dict[int, tuple] = {}
        self.live_bytes = self.peak_bytes = self.op_bytes = 0
        self.coll: dict[str, int] = {}
        for t in _tensors(resident):
            self._track(t)
        self.resident_bytes = self.live_bytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (weakref.ref(st, functools.partial(self._free,
                                                             key)), n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int, _ref) -> None:
        _, n = self._live.pop(key)
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _DEVICE:                 # a fake tensor's .device
            return out
        name = func._schema.name
        if name.startswith("c10d::"):
            op = _COLL_OPS.get(name[len("c10d::"):])
            if op is not None:
                self.coll[op] = self.coll.get(op, 0) + sum(
                    _nbytes(t) for t in _tensors(args[0]))
        outs = _flat(out, [])
        if not name.startswith("c10d::") and not _is_view(func):
            self.op_bytes += sum(_nbytes(t) for t in _flat(
                (args, kwargs), outs[:]))
        for t in outs:
            self._track(t)
        return out

    def collectives(self) -> dict:
        """The reference's ``collective_bytes`` dict: bytes by op, and
        their ``total``."""
        return {**self.coll, "total": sum(self.coll.values())}


def collective_bytes(fn, *args, **kwargs) -> dict:
    """Sum the per-device output bytes of every collective ``fn(*args,
    **kwargs)`` issues, by op name (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``broadcast``), with their
    ``total``: the counterpart of the reference's HLO parse."""
    with StepTrace() as tr:
        fn(*args, **kwargs)
    return tr.collectives()


@contextlib.contextmanager
def fake_world(mesh):
    """Rank 0 of a fake process group of ``mesh.size`` ranks (none for one
    rank), torn down on exit with the axis groups ``launch/mesh.py``
    cached for it.  Refuses to start inside a real process group."""
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialized; "
                           "the dry run makes a fake one for each cell")
    if mesh is None or mesh.size == 1:
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    world = id(dist.group.WORLD)
    try:
        yield
    finally:
        for key in [k for k in mesh_mod._GROUPS if k[0] == world]:
            del mesh_mod._GROUPS[key]
        dist.destroy_process_group()


def _batch(cfg, specs: dict, device, seed) -> dict:
    """Tensors of the specs' shapes and dtypes on ``device``: zeros (fake
    under the dry run), or with ``seed`` tokens drawn below the vocab,
    positions counting up and floats from a normal."""
    out = {}
    gen = None if seed is None else \
        torch.Generator(device=device).manual_seed(seed)
    for name, sd in specs.items():
        kw = dict(dtype=sd.dtype, device=device)
        if gen is None:
            out[name] = torch.zeros(sd.shape, **kw)
        elif name == "positions":
            out[name] = torch.arange(sd.shape[-1], **kw).expand(
                sd.shape).contiguous()
        elif sd.dtype.is_floating_point:
            out[name] = torch.randn(sd.shape, generator=gen, **kw)
        else:
            out[name] = torch.randint(0, cfg.vocab, sd.shape, generator=gen,
                                      **kw)
    return out


def _empty_like_meta(model: torch.nn.Module, device):
    """``model`` with every ``device="meta"`` parameter replaced by an
    uninitialized one of its shape and dtype on ``device`` (a fake tensor
    inside a ``FakeTensorMode``)."""
    for mod in model.modules():
        for name, p in mod._parameters.items():
            if p is not None:
                mod._parameters[name] = torch.nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device=device),
                    requires_grad=p.requires_grad)
    return model


def build_lowerable(cfg, shape_name: str, mesh, *, accum: int = 4,
                    kvq_splits: int = 1, specs: dict | None = None,
                    device="cpu", seed: int | None = None):
    """-> (step, args) of the cell: the port's step for the shape's kind
    and rank 0's arguments on ``device``.  Weights are
    ``init_params(device="meta", mesh=mesh, rank=0)`` made real with
    ``to_empty`` (fake inside a ``FakeTensorMode``), or drawn from
    ``seed``: f32 masters with AdamW state and a no-op ``LossScale`` for a
    train cell (``TrainConfig(policy="bf16", accum=accum)``, remat every
    block), bf16 for prefill and decode.  The inputs are ``specs``
    (default ``configs.input_specs(cfg, shape_name)``): the global batch,
    the decode's tokens and ``enc_out``, and rank 0's block of the decode
    cache (its rows where they split over DP, its KV heads or slots on
    the model axis).  ``mesh`` None: one device, no mesh."""
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train.serve_step import make_serve_steps
    from repro_torch.train.train_step import (TrainConfig, init_loss_scale,
                                              make_train_step)
    from repro_torch.distributed import sharding as shd
    kind = configs.SHAPES[shape_name]["kind"]
    specs = configs.input_specs(cfg, shape_name) if specs is None else specs
    dtype = torch.float32 if kind == "train" else torch.bfloat16
    if seed is None:
        model = _empty_like_meta(transformer.init_params(
            cfg, device="meta", dtype=dtype, mesh=mesh, rank=0), device)
    else:
        model = transformer.init_params(cfg, seed, device=device,
                                        dtype=dtype, mesh=mesh, rank=0)
    if kind == "train":
        model.requires_grad_()
        tc = TrainConfig(policy="bf16", accum=accum)
        step, _ = make_train_step(cfg, tc, specs, mesh)
        opt = adamw.init(dict(model.named_parameters()))
        ls = init_loss_scale(tc, device)
        return step, (model, opt, ls, _batch(cfg, specs, device, seed))
    serve_mesh = mesh_mod.Mesh(data=1, model=1) if mesh is None else mesh
    if kind == "prefill":
        step, _ = make_serve_steps(cfg, serve_mesh, specs, kind="prefill")
        return step, (model, _batch(cfg, specs, device, seed))
    step, _ = make_serve_steps(cfg, serve_mesh, specs, kind="decode",
                               kvq_splits=kvq_splits)
    b = specs["tokens_t"].shape[0]
    n_dp = shd.dp_size(serve_mesh)
    cache = transformer.init_cache(
        cfg, b // n_dp if b % n_dp == 0 else b, _cache_len(specs["cache"]),
        quantized=True, device=device, mesh=mesh)
    rest = {k: v for k, v in specs.items() if k in ("tokens_t", "enc_out")}
    args = [model, cache, *_batch(cfg, rest, device, seed).values()]
    return step, tuple(args)


def _cache_len(cache: dict) -> int:
    """The slots of a decode cache (its sequence axis); 0 for a cache
    with none (the pure SSM's)."""
    from repro_torch.models import transformer
    for name, ax in transformer.CACHE_SEQ_AXES.items():
        if name in cache:
            return cache[name].shape[ax]
    return 0


def trace_step(step, args) -> dict:
    """Run ``step(*args)`` once under the counting modes and
    ``trace_for_card``: -> flops, bytes, coll, coll_by_op, peak (live
    bytes), resident (bytes before the step), kernel_calls.  ``args``
    are fake tensors (a ``FakeTensorMode`` active)."""
    from torch.utils.flop_counter import FlopCounterMode
    flop = FlopCounterMode(display=False)
    with device_mod.trace_for_card() as calls, flop, \
            StepTrace(args) as tr:
        step(*args)
    coll = tr.collectives()
    return {"flops": float(flop.get_total_flops()), "bytes": float(tr.op_bytes),
            "coll": float(coll["total"]), "coll_by_op": coll,
            "peak": tr.peak_bytes, "resident": tr.resident_bytes,
            "kernel_calls": dict(sorted(calls.items()))}


def _memory_floor_bytes(cfg, shape_name: str, mesh, accum: int) -> float:
    """Analytic per-device HBM-traffic floor for one step (bytes).

    Counts only unavoidable streams: parameter reads (fwd/bwd/remat x
    microbatches), optimizer state read+write, checkpointed activations
    write+read, logit stream, and (serving) the KV-cache read.  Fusable
    element-wise traffic is deliberately excluded -> a true lower bound."""
    sh = configs.SHAPES[shape_name]
    kind = sh["kind"]
    n_model = mesh.shape["model"]
    n_dp = mesh.size // n_model
    p_dev = cfg.param_count() / n_model          # params per device (approx)

    if kind == "train":
        ub_local = max(1, sh["batch"] // (n_dp * accum))
        param_stream = 3 * 2 * p_dev * accum         # fwd+bwd+remat, bf16
        opt_stream = 10 * 4 * p_dev                  # p,m,v read+write f32 + grads
        ckpt = 2 * cfg.n_layers * ub_local * sh["seq"] * cfg.d_model * 2 * accum
        logits = 10 * ub_local * sh["seq"] * (cfg.vocab / n_model) * accum
        return param_stream + opt_stream + ckpt + logits
    if kind == "prefill":
        b_local = max(1, sh["batch"] // n_dp)
        acts = 2 * cfg.n_layers * b_local * sh["seq"] * cfg.d_model * 2
        cache = _cache_bytes_per_device(cfg, sh["batch"], sh["seq"], mesh)
        return 2 * p_dev + acts + cache
    # decode: params once + cache read once
    cache = _cache_bytes_per_device(cfg, sh["batch"], sh["seq"], mesh)
    return 2 * p_dev + cache


def _cache_bytes_per_device(cfg, batch: int, seq: int, mesh) -> float:
    """int8 KV (or MLA-latent / SSM-state) cache bytes per device."""
    n_chips = mesh.size
    L = cfg.n_layers
    total = 0.0
    if cfg.mixer in ("attn", "hybrid"):
        if cfg.mla is not None:
            m = cfg.mla
            total += L * batch * seq * (m.kv_lora_rank + m.qk_rope_dim) * 2
        else:
            total += L * batch * cfg.n_kv * seq * cfg.head_dim * 2 * 1  # int8 k+v
            total += L * batch * cfg.n_kv * seq * 2 * 4                 # scales
    if cfg.mixer in ("ssm", "hybrid"):
        s = cfg.ssm
        total += L * batch * s.heads * s.d_state * s.head_p * 4
    # cache is sharded over every mesh axis we can use (B and Hkv/S rules);
    # assume full spread except the pod axis for B=1 long-context
    spread = n_chips if batch > 1 else mesh.shape["model"] * (
        mesh.shape.get("data", 1))
    return total / spread


def model_flops(cfg, shape_name: str) -> float:
    """6 (train) or 2 (serve) x active parameters x tokens of the cell,
    over every device (the reference's ``model_flops``)."""
    sh = configs.SHAPES[shape_name]
    kind = sh["kind"]
    tokens = sh["batch"] * sh["seq"] if kind in ("train", "prefill") \
        else sh["batch"]
    return (6 if kind == "train" else 2) * cfg.active_param_count() * tokens


def _attn_backend(calls: dict) -> str:
    if calls.get("flash_fwd_sm90"):
        return "sm90"
    return "fma" if calls.get("flash_fwd") else "plain"


def _plan_info(cfg, shape_name: str, mesh, accum: int, calls: dict) -> dict:
    """The port's planner on the cell (advisory: an error is reported
    under ``plan_error`` / ``serve_plan_error``, never raised)."""
    from repro_torch import plan as plan_mod
    sh = configs.SHAPES[shape_name]
    kind = sh["kind"]
    if kind == "train":
        try:
            from repro_torch.train.train_step import (TrainConfig,
                                                      microbatch_specs,
                                                      plan_profile)
            tc = TrainConfig(policy="bf16", accum=accum)
            batch_sds = {"tokens": torch.empty((sh["batch"], sh["seq"]),
                                               dtype=torch.int32,
                                               device="meta")}
            mb_b, mb_s = microbatch_specs(batch_sds, accum=accum,
                                          mesh=mesh)["tokens"].shape
            # the port's per-device profile: the bf16 policy, divided
            # over the model axis (train_step.plan_profile)
            prof = plan_profile(cfg, tc, batch_sds, mesh)
            rep = plan_mod.plan_report(prof, plan_mod.RematPlan.uniform(
                cfg.n_layers, cfg.n_layers))
            flop_rep = plan_mod.flash_attn_flop_report(cfg, mb_b, mb_s)
            return {
                "plan_peak_bytes": rep["peak_bytes"],
                "plan_no_remat_bytes": rep["no_remat_bytes"],
                "plan_n_segments": rep["n_segments"],
                "attn_backend": _attn_backend(calls),
                # one profile: the port runs the flash op wherever it is
                # eligible, so the two reference keys agree
                "attn_resid_bytes": prof.total_resid_bytes(),
                "flash_resid_bytes": prof.total_resid_bytes(),
                "flash_bwd_recompute_flops": sum(
                    plan_mod.flash_bwd_recompute_flops(cfg, mb_b, mb_s)),
                "flash_attn_dense_flops": flop_rep["dense_flops"],
                "flash_attn_visited_flops": flop_rep["visited_flops"],
                "flash_tile_skip_frac": flop_rep["skip_frac"],
            }
        except Exception as e:  # noqa: BLE001 - advisory, never fail a cell
            return {"plan_error": f"{type(e).__name__}: {e}"[:200]}
    try:
        cache_rep = plan_mod.kv_cache_report(cfg, sh["batch"], sh["seq"])
        info = {"kv_cache_int8_bytes": cache_rep["int8_bytes"],
                "kv_cache_f32_bytes": cache_rep["f32_bytes"],
                "kv_cache_quant_ratio": round(cache_rep["ratio"], 3)}
        if kind == "decode" and cache_rep["eligible"]:
            dec = plan_mod.decode_tile_report(cfg, sh["batch"], sh["seq"])
            info.update(
                decode_visited_tile_steps=dec["visited_tile_steps"],
                decode_dense_tile_steps=dec["dense_tile_steps"],
                decode_tile_skip_frac=round(dec["skip_frac"], 4),
                decode_visited_kv_gbytes=dec["visited_kv_bytes"] / 1e9,
                decode_dense_kv_gbytes=dec["dense_kv_bytes"] / 1e9)
        return info
    except Exception as e:  # noqa: BLE001 - advisory, never fail a cell
        return {"serve_plan_error": f"{type(e).__name__}: {e}"[:200]}


def dryrun_cell(arch: str, shape_name: str, mesh, *, verbose=True,
                accum: int = 4, cfg=None, reduced: bool = False) -> dict:
    """Trace one step of the cell at full depth as rank 0 of ``mesh`` and
    read its terms (module docstring).  ``cfg`` overrides the arch's
    config (a smoke config); ``reduced`` takes ``input_specs``'s reduced
    shapes.  The analytic terms (``memory_lb_bytes``, ``model_flops``)
    stay the shape's, as in the reference."""
    cfg = configs.get_config(arch) if cfg is None else cfg
    if cfg.moe is not None and cfg.moe.capacity_factor == 0:
        raise ValueError(
            f"{cfg.arch_id}: the dropless MoE dispatch (capacity_factor 0) "
            f"sizes each expert's group on the host from the routing, which "
            f"a fake-tensor trace does not have; the dry run takes the "
            f"capacity dispatch only")
    from torch._subclasses.fake_tensor import FakeTensorMode
    kind = configs.SHAPES[shape_name]["kind"]
    specs = configs.input_specs(cfg, shape_name, reduced=reduced)
    with fake_world(mesh), FakeTensorMode():
        t0 = time.time()
        step, args = build_lowerable(cfg, shape_name, mesh, accum=accum,
                                     specs=specs)
        t_lower = time.time() - t0
        t0 = time.time()
        c = trace_step(step, args)
        t_compile = time.time() - t0
        del step, args
    flops, bytes_acc, coll_total = c["flops"], c["bytes"], c["coll"]
    coll = {k: v for k, v in c["coll_by_op"].items() if k != "total"}
    n_chips = mesh.size
    mem_lb = _memory_floor_bytes(cfg, shape_name, mesh, accum)
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": mem_lb / HBM_BW,
        "collective_s": coll_total / LINK_BW,
    }
    terms_ub = {"memory_ub_s": bytes_acc / HBM_BW}
    bottleneck = max(terms, key=terms.get)
    n_active = cfg.active_param_count()
    mflops = model_flops(cfg, shape_name)
    plan_info = _plan_info(cfg, shape_name, mesh, accum, c["kernel_calls"])
    result = {
        "arch": arch, "shape": shape_name, "mesh": describe(mesh),
        "kind": kind,
        "params_b": round(cfg.param_count() / 1e9, 3),
        "active_params_b": round(n_active / 1e9, 3),
        "hlo_gflops": flops / 1e9,
        "hlo_gbytes": bytes_acc / 1e9,
        "collective_gbytes": coll_total / 1e9,
        "collectives": {k: v / 1e9 for k, v in coll.items()},
        "raw_uncorrected": {"flops": flops, "bytes": bytes_acc,
                            "coll": coll_total},
        "bytes_per_device": int(c["peak"]),
        "temp_bytes_per_device": int(c["peak"] - c["resident"]),
        "arg_bytes_per_device": int(c["resident"]),
        **{k: float(v) for k, v in terms.items()},
        "bottleneck": bottleneck,
        "model_flops": mflops,
        "useful_flops_frac": (mflops / n_chips) / flops if flops else 0.0,
        "memory_ub_s": terms_ub["memory_ub_s"],
        "memory_lb_bytes": mem_lb,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "kernel_calls": c["kernel_calls"],
        **plan_info,
    }
    if verbose:
        _report(result, terms, terms_ub)
    return result


def _report(result: dict, terms: dict, terms_ub: dict) -> None:
    r = result
    print(f"[{r['arch']} x {r['shape']} @ {r['mesh']}]")
    print(f"  trace {r['compile_s']:.0f}s | {r['hlo_gflops'] / 1e3:.2f} TF, "
          f"{r['hlo_gbytes']:.1f} GB, coll {r['collective_gbytes']:.2f} GB")
    print(f"  terms: compute {terms['compute_s'] * 1e3:.3f} ms | "
          f"memory(lb) {terms['memory_s'] * 1e3:.3f} ms "
          f"(ub {terms_ub['memory_ub_s'] * 1e3:.1f}) | "
          f"collective {terms['collective_s'] * 1e3:.3f} ms "
          f"-> {r['bottleneck']}")
    print(f"  per-device bytes: temp "
          f"{r['temp_bytes_per_device'] / 2**30:.2f} GiB, "
          f"args {r['arg_bytes_per_device'] / 2**30:.2f} GiB, peak "
          f"{r['bytes_per_device'] / 2**30:.2f} GiB of 80 GB")
    print(f"  kernels: {r['kernel_calls']}")
    if "plan_peak_bytes" in r:
        print(f"  planner: activation peak "
              f"{r['plan_peak_bytes'] / 2**30:.2f} GiB planned (per-block "
              f"remat) vs {r['temp_bytes_per_device'] / 2**30:.2f} GiB "
              f"traced temp (no-remat would be "
              f"{r['plan_no_remat_bytes'] / 2**30:.2f} GiB)")
        print(f"  attn: backend={r['attn_backend']} "
              f"resid {r['attn_resid_bytes'] / 2**20:.1f} MiB "
              f"(+ {r['flash_bwd_recompute_flops'] / 1e9:.1f} recompute "
              f"GFLOPs)")
        if r.get("flash_tile_skip_frac"):
            print(f"  flash sparse grids: "
                  f"{r['flash_attn_visited_flops'] / 1e9:.1f} GFLOPs "
                  f"visited vs {r['flash_attn_dense_flops'] / 1e9:.1f}"
                  f" dense ({r['flash_tile_skip_frac'] * 100:.0f}% of "
                  f"KV tile-steps skipped)")
    if r.get("kv_cache_int8_bytes"):
        print(f"  kv cache: int8 {r['kv_cache_int8_bytes'] / 2**30:.2f} GiB "
              f"vs f32 {r['kv_cache_f32_bytes'] / 2**30:.2f} GiB "
              f"({r['kv_cache_quant_ratio']:.2f}x)")
    if "decode_visited_tile_steps" in r:
        print(f"  decode tiles: {r['decode_visited_tile_steps']} visited vs "
              f"{r['decode_dense_tile_steps']} dense "
              f"({r['decode_tile_skip_frac'] * 100:.0f}% skipped; kv stream "
              f"{r['decode_visited_kv_gbytes']:.2f} vs "
              f"{r['decode_dense_kv_gbytes']:.2f} GB)")
    print(f"  useful-FLOP fraction {r['useful_flops_frac']:.2f}")
    sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", type=str, default=None)
    args = ap.parse_args(argv)

    if args.both_meshes:
        meshes = [make_production_mesh(), make_production_mesh(multi_pod=True)]
    else:
        meshes = [make_production_mesh(multi_pod=args.multi_pod)]

    cells = []
    if args.all:
        for arch in configs.list_archs():
            cfg = configs.get_config(arch)
            for shape in configs.applicable_shapes(cfg):
                cells.append((arch, shape))
    else:
        cells = [(args.arch, args.shape)]

    results, failures = [], []
    for mesh in meshes:
        for arch, shape in cells:
            try:
                results.append(dryrun_cell(arch, shape, mesh))
            except Exception as e:  # noqa: BLE001 - report and continue
                print(f"[FAIL] {arch} x {shape} @ {describe(mesh)}: "
                      f"{type(e).__name__}: {e}")
                sys.stdout.flush()
                failures.append({"arch": arch, "shape": shape,
                                 "mesh": describe(mesh),
                                 "error": str(e)[:2000]})
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"results": results, "failures": failures}, f, indent=1)
    print(f"\n{len(results)} cells OK, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
