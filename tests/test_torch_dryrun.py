"""The port's dry run (``repro_torch.launch.dryrun``) and its inputs
(``repro_torch.configs`` ``SHAPES`` / ``applicable_shapes`` /
``input_specs``) against the JAX package's, and the counts it reads off a
fake-tensor trace against real runs.

The reference's dry run compiles full-size models on 512 emulated
devices (minutes a cell); here only its inputs and its analytic terms
are held against it, exactly.  The port's traced numbers are held
against real CPU runs of the same steps (FLOPs, live-storage peak) and
against a real two-rank gloo run (collective bytes, ranks spawned through
``tests/tp_ranks.py``); the kernel ops' fakes against the planner's tile
counts.  ``repro.launch.dryrun`` appends 512 host devices to
``XLA_FLAGS`` at import: it is imported only after ``jax.devices()`` has
fixed this worker's device count, and ``XLA_FLAGS`` is restored after.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tp_ranks
from repro_torch import configs
from repro_torch.core import device as device_mod
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import Mesh

THIS = pathlib.Path(__file__).resolve()
ROOT = THIS.parents[1]
ARCHS = configs.list_archs()
PROD = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


def _jax_dryrun():
    """``repro.launch.dryrun``, imported without changing this worker's
    JAX device count."""
    import jax
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdr
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return jdr


def _smoke(arch: str):
    """The arch's smoke config at head_dim 64, which the card's decode
    kernel takes (M-RoPE's sections scaled to it); MLA keeps its own."""
    cfg = configs.smoke_config(arch)
    if cfg.mla is not None:
        return cfg
    kw = {"head_dim": 64}
    if cfg.mrope_sections is not None:
        kw["mrope_sections"] = tuple(4 * s for s in cfg.mrope_sections)
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Parity of the inputs and of the analytic terms with the reference.
# ---------------------------------------------------------------------------
def test_shapes_and_applicable_shapes_match_reference():
    from repro import configs as jconfigs
    assert configs.SHAPES == jconfigs.SHAPES
    for arch in ARCHS:
        assert configs.applicable_shapes(configs.get_config(arch)) == \
            jconfigs.applicable_shapes(jconfigs.get_config(arch)), arch


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).removeprefix(
                "torch."))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    from repro import configs as jconfigs
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for shape in configs.applicable_shapes(cfg):
        for reduced in (True, False):
            got = configs.input_specs(cfg, shape, reduced=reduced)
            want = jconfigs.input_specs(jcfg, shape, reduced=reduced)
            assert all(v.device.type == "meta" for v in
                       dryrun._tensors(got)), (shape, reduced)
            assert _leaves(got) == _leaves(want), (shape, reduced)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_terms_match_reference(arch):
    """The memory floor, the cache bytes, the model FLOPs and the
    parameter counts of every cell on both production meshes, exactly."""
    jdr = _jax_dryrun()
    from repro import configs as jconfigs
    from repro.launch.mesh import abstract_mesh
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert round(cfg.param_count() / 1e9, 3) == \
        round(jcfg.param_count() / 1e9, 3)
    assert cfg.active_param_count() == jcfg.active_param_count()
    for shape, axes in PROD:
        mesh, jmesh = Mesh(**dict(zip(axes, shape))), abstract_mesh(shape,
                                                                     axes)
        for name in configs.applicable_shapes(cfg):
            sh = configs.SHAPES[name]
            assert dryrun._memory_floor_bytes(cfg, name, mesh, 4) == \
                jdr._memory_floor_bytes(jcfg, name, jmesh, 4), (name, shape)
            assert dryrun._cache_bytes_per_device(
                cfg, sh["batch"], sh["seq"], mesh) == \
                jdr._cache_bytes_per_device(jcfg, sh["batch"], sh["seq"],
                                            jmesh), (name, shape)
            tokens = sh["batch"] * (sh["seq"] if sh["kind"] != "decode"
                                    else 1)
            mult = 6 if sh["kind"] == "train" else 2
            assert dryrun.model_flops(cfg, name) == \
                mult * jcfg.active_param_count() * tokens


# ---------------------------------------------------------------------------
# The counted numbers.
# ---------------------------------------------------------------------------
def test_collective_bytes_exact_on_a_fake_world():
    """A crafted sequence on rank 0 of a fake 256-rank world: each op's
    per-device output bytes, exactly; the world and the axis groups
    ``launch/mesh.py`` cached for it are gone afterwards."""
    mesh = Mesh(data=16, model=16)
    with dryrun.fake_world(mesh):
        world = id(dist.group.WORLD)
        model = mesh_mod.axis_group(mesh, "model")
        data = mesh_mod.axis_group(mesh, "data")

        def sequence():
            x = torch.zeros(4, 8)                           # 128 B
            dist.all_reduce(x, group=model)
            dist.all_reduce(x.bfloat16(), group=data)        # 64 B
            parts = [torch.zeros(2, 3, dtype=torch.bfloat16)
                     for _ in range(16)]
            dist.all_gather(parts, parts[0], group=model)    # 16 x 12 B
            dist.all_gather_into_tensor(torch.zeros(16 * 4, 8), x,
                                        group=model)         # 2048 B
            dist.reduce_scatter_tensor(torch.zeros(2, 8), torch.zeros(32, 8),
                                       group=model)          # 64 B
            dist.all_to_all_single(torch.zeros(16, 5), torch.zeros(16, 5),
                                   group=data)               # 320 B
            dist.broadcast(x, src=0, group=model)            # 128 B
            w = dist.all_reduce(torch.zeros(3, dtype=torch.int32),
                                async_op=True)               # 12 B, world
            w.wait()

        got = dryrun.collective_bytes(sequence)
        assert any(k[0] == world for k in mesh_mod._GROUPS)
    assert got == {"all-reduce": 128 + 64 + 12, "all-gather": 192 + 2048,
                   "reduce-scatter": 64, "all-to-all": 320,
                   "broadcast": 128, "total": 204 + 2240 + 64 + 320 + 128}
    assert not dist.is_initialized()
    assert not any(k[0] == world for k in mesh_mod._GROUPS)


def test_fake_world_refuses_a_real_process_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            with dryrun.fake_world(Mesh(data=2, model=2)):
                pass
    finally:
        dist.destroy_process_group()


def _counted(step, args) -> tuple:
    """(FLOPs, live peak, resident bytes, op bytes) of one step, plain
    routes (no card trace)."""
    from torch.utils.flop_counter import FlopCounterMode
    flop = FlopCounterMode(display=False)
    with flop, dryrun.StepTrace(args) as tr:
        step(*args)
    return (flop.get_total_flops(), tr.peak_bytes, tr.resident_bytes,
            tr.op_bytes)


@pytest.mark.parametrize("arch,shape", [
    ("llama3-8b", "train_4k"), ("hymba-1.5b", "train_4k"),
    ("deepseek-moe-16b", "train_4k"), ("llama3-8b", "prefill_32k"),
    ("hymba-1.5b", "decode_32k")])
def test_fake_trace_equals_a_real_cpu_run(arch, shape):
    """At smoke size on the plain routes, a fake trace and a real CPU run
    of the same step count the same FLOPs, the same peak of live storages
    and the same bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = configs.smoke_config(arch)
    specs = configs.input_specs(cfg, shape, reduced=True)
    torch.manual_seed(0)
    real = _counted(*dryrun.build_lowerable(cfg, shape, None, accum=2,
                                            specs=specs, seed=0))
    with FakeTensorMode():
        fake = _counted(*dryrun.build_lowerable(cfg, shape, None, accum=2,
                                                specs=specs))
    assert fake == real
    assert real[0] > 0 and real[1] > real[2] > 0


def _coll_job(rank, world, arch, shape):
    """A real rank of a gloo world: the cell's step at smoke size on (1,
    world) under the counting mode (plain routes) -> collective bytes."""
    cfg = _smoke(arch)
    mesh = Mesh(data=1, model=world)
    step, args = dryrun.build_lowerable(
        cfg, shape, mesh, accum=2,
        specs=configs.input_specs(cfg, shape, reduced=True), seed=0)
    with dryrun.StepTrace(args) as tr:
        step(*args)
    return tr.collectives()


@pytest.fixture(scope="module")
def gloo_runs():
    tmp = tp_ranks.tmpdir("dryrun_")
    jobs = {c: tp_ranks.start(THIS, tmp, "coll", 2, arch=c[0], shape=c[1])
            for c in GLOO_CELLS}
    return {c: tp_ranks.results(h) for c, h in jobs.items()}


GLOO_CELLS = [("llama3-8b", "train_4k"), ("llama3-8b", "decode_32k"),
              ("hymba-1.5b", "prefill_32k")]


@pytest.mark.parametrize("cell", GLOO_CELLS, ids="-".join)
def test_fake_trace_collectives_equal_a_gloo_run(cell, gloo_runs):
    """Rank 0's fake trace on (1, 2), on the card's routes, sends the
    bytes a real two-rank gloo run's rank 0 sends, op by op."""
    arch, shape = cell
    cfg = _smoke(arch)
    got = dryrun.dryrun_cell(arch, shape, Mesh(data=1, model=2),
                             verbose=False, cfg=cfg, reduced=True, accum=2)
    want = gloo_runs[cell][0]
    assert got["raw_uncorrected"]["coll"] == want["total"] > 0
    assert got["collectives"] == {k: v / 1e9 for k, v in want.items()
                                  if k != "total"}


def _kernel_state():
    from repro_torch.kernels.flash import ops as fo
    from repro_torch.kernels.kvq import ops as ko
    from repro_torch.kernels.ssd import ops as so
    kernels = [k for mod in (fo, ko, so) for k in vars(mod).values()
               if isinstance(k, type(fo.KERNEL))]
    return [(k.launches, k._fn) for k in kernels]


@pytest.mark.parametrize("window", [0, 1024])
def test_flash_fakes_count_the_planners_flops(window):
    """The forward and backward ops' FLOPs, traced on fake bf16 tensors
    at llama3-8b's heads, equal ``plan.flash_attn_flop_report``'s visited
    FLOPs of one layer; no kernel is launched or bound."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import plan
    from repro_torch.kernels.flash import ops as fo
    b, s = 2, 4096
    cfg = dataclasses.replace(configs.get_config("llama3-8b"), n_layers=1,
                              window=window)
    h, hkv, d = cfg.n_heads, cfg.n_kv, cfg.head_dim
    before = _kernel_state()
    with FakeTensorMode(), device_mod.trace_for_card() as calls:
        q = torch.empty(b, h, s, d, dtype=torch.bfloat16, requires_grad=True)
        k = torch.empty(b, hkv, s, d, dtype=torch.bfloat16,
                        requires_grad=True)
        v = torch.empty(b, hkv, s, d, dtype=torch.bfloat16,
                        requires_grad=True)
        flop = FlopCounterMode(display=False)
        with flop:
            fo.flash_attention(q, k, v, window=window).sum().backward()
    assert flop.get_total_flops() == \
        plan.flash_attn_flop_report(cfg, b, s)["visited_flops"]
    assert dict(calls) == {"flash_fwd_sm90": 1, "flash_bwd_delta": 1,
                           "flash_bwd_dq_sm90": 1, "flash_bwd_dkv_sm90": 1}
    assert _kernel_state() == before
    assert all(fn is None for _, fn in before)


@pytest.mark.parametrize("splits", [1, 4])
def test_decode_fake_counts_the_planners_flops(splits):
    """The decode op on fake tensors: its FLOPs equal
    ``plan.decode_tile_report``'s visited FLOPs of one layer of a full
    cache, its outputs are the split partials at ``resolve_splits``'s
    count (merged outside the op), and nothing launches."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import plan
    from repro_torch.kernels.kvq import ops as ko
    b, s = 8, 2048
    cfg = dataclasses.replace(configs.get_config("llama3-8b"), n_layers=1)
    h, hkv, d = cfg.n_heads, cfg.n_kv, cfg.head_dim
    before = _kernel_state()
    seen = []
    with FakeTensorMode(), device_mod.trace_for_card() as calls:
        q = torch.empty(b, h, d, dtype=torch.bfloat16)
        kq = torch.empty(b, hkv, s, d, dtype=torch.int8)
        ks = torch.empty(b, hkv, s)
        lengths = torch.full((b,), s, dtype=torch.int32)
        real_op = ko._decode_op

        def spy(*args):
            out = real_op(*args)
            seen.append([tuple(t.shape) for t in out])
            return out
        ko._decode_op = spy
        try:
            flop = FlopCounterMode(display=False)
            with flop:
                out = ko.decode_attention(q, kq, ks, kq, ks, lengths=lengths,
                                          splits=splits)
        finally:
            ko._decode_op = real_op
    assert tuple(out.shape) == (b, h, d) and out.dtype == torch.float32
    n_sp = ko.resolve_splits(s, splits)
    g = h // hkv
    assert seen == ([[(b, hkv, g, d)]] if n_sp == 1 else
                    [[(b, hkv, n_sp, g, d), (b, hkv, n_sp, g),
                      (b, hkv, n_sp, g)]])
    assert flop.get_total_flops() == plan.decode_tile_report(
        cfg, b, s, splits=splits)["visited_flops"]
    assert dict(calls) == {"flash_decode": 1}
    assert _kernel_state() == before


def test_ssd_fakes_count_the_chunk_products():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.ssd import ops as so
    g, t, q, n, p = 48, 4, 128, 128, 64
    before = _kernel_state()
    with FakeTensorMode(), device_mod.trace_for_card() as calls:
        c = torch.empty(2, t, q, n, requires_grad=True)
        bm = torch.empty(2, t, q, n, requires_grad=True)
        x = torch.empty(g, t, q, p, requires_grad=True)
        a = torch.empty(g, t, q, requires_grad=True)
        flop = FlopCounterMode(display=False)
        with flop:
            y, st = so.ssd_chunk(c, bm, x, a)
            (y.sum() + st.sum()).backward()
    assert flop.get_total_flops() == so.chunk_flops(g, t, q, n, p) + \
        so.chunk_bwd_flops(g, t, q, n, p)
    assert dict(calls) == {"ssd_chunk_sm90": 1, "ssd_chunk_bwd_sm90": 1}
    assert _kernel_state() == before


# ---------------------------------------------------------------------------
# Guards and the MoE count.
# ---------------------------------------------------------------------------
def test_trace_for_card_raises_on_a_real_tensor():
    from repro_torch.kernels.flash import ops as fo
    from repro_torch.kernels.kvq import ops as ko
    from repro_torch.kernels.ssd import ops as so
    q = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    with device_mod.trace_for_card():
        with pytest.raises(RuntimeError, match="real cpu tensor"):
            fo.flash_attention(q, q, q)
        with pytest.raises(RuntimeError, match="real cpu tensor"):
            ko.decode_attention(q[:, :, 0], torch.zeros(1, 2, 64, 64,
                                                        dtype=torch.int8),
                                torch.zeros(1, 2, 64),
                                torch.zeros(1, 2, 64, 64, dtype=torch.int8),
                                torch.zeros(1, 2, 64))
        x = torch.zeros(2, 1, 16, 16)
        with pytest.raises(RuntimeError, match="real cpu tensor"):
            so.ssd_chunk(x, x, x, torch.zeros(2, 1, 16))
    assert not device_mod.card_trace_active()
    # outside the context the plain versions run as before
    assert fo.flash_attention(q, q, q).shape == q.shape


def test_moe_count_is_bit_equal_to_bincount():
    from repro_torch.models import moe
    rng = np.random.default_rng(0)
    for t, e, k in ((64, 8, 2), (4096, 64, 6), (1000, 40, 8)):
        x = torch.from_numpy(rng.standard_normal((t, 32)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((32, e)).astype(np.float32))
        _, top_i, aux = moe.router_topk(x, w, k)
        probs = torch.softmax(x @ w, dim=-1)
        f = torch.bincount(top_i.reshape(-1), minlength=e).float()
        f = f / f.sum().clamp_min(1.0)
        want = e * (f * probs.mean(0)).sum()
        assert torch.equal(aux, want), (t, e, k)


# ---------------------------------------------------------------------------
# Cells and the CLI.
# ---------------------------------------------------------------------------
def _reference_keys() -> dict:
    """The reference's result keys by where they come from: the
    ``result`` dict, the train plan's and the serve plan's, the decode
    tiles' (read from ``repro/launch/dryrun.py``'s source)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    keys: dict = {"result": set(), "plan_info": set(), "update": set()}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            name = getattr(node.targets[0], "id", None)
            if name in ("result", "plan_info"):
                keys[name] |= {k.value for k in node.value.keys
                               if isinstance(k, ast.Constant)}
        if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                  None) == "update":
            keys["update"] |= {kw.arg for kw in node.keywords}
    keys["plan_info"] -= {"plan_error", "serve_plan_error"}
    keys["result"] |= {"compute_s", "memory_s", "collective_s"}  # **terms
    return keys


REF = _reference_keys()
TRAIN_PLAN = {k for k in REF["plan_info"] if not k.startswith("kv_cache")}
SERVE_PLAN = REF["plan_info"] - TRAIN_PLAN


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_cell_runs_every_smoke_cell(arch):
    """Every applicable shape, reduced, of the arch's smoke config on
    Mesh(data=2, model=2): the reference's keys, the port's
    ``kernel_calls``, sane terms."""
    cfg = _smoke(arch)
    for shape in configs.applicable_shapes(cfg):
        r = dryrun.dryrun_cell(arch, shape, Mesh(data=2, model=2),
                               verbose=False, cfg=cfg, reduced=True,
                               accum=2)
        kind = configs.SHAPES[shape]["kind"]
        want = REF["result"] | (TRAIN_PLAN if kind == "train" else
                                SERVE_PLAN)
        if kind == "decode" and r.get("kv_cache_int8_bytes"):
            want = want | REF["update"]
        assert set(r) == want | {"kernel_calls"}, (shape, set(r) ^ want)
        assert r["bytes_per_device"] >= r["arg_bytes_per_device"] > 0
        assert r["bottleneck"] in ("compute_s", "memory_s", "collective_s")
        assert r["hlo_gflops"] > 0 and r["collective_gbytes"] > 0
        flash = cfg.mla is None and cfg.mrope_sections is None and \
            cfg.mixer != "ssm"
        if kind != "decode":
            assert bool(r["kernel_calls"].get("flash_fwd_sm90")) == flash
        if kind == "train":
            assert r["attn_backend"] == ("sm90" if flash else "plain")


def test_refused_cells_fail_and_main_returns_one(monkeypatch, tmp_path,
                                                 capsys):
    """A dropless MoE (capacity_factor 0) and an MoE split that does not
    divide the model axis land in ``failures`` with the reference's
    ``[FAIL]`` line, and ``main`` returns 1."""
    smoke = configs.smoke_config("deepseek-moe-16b")
    dropless = dataclasses.replace(smoke, moe=dataclasses.replace(
        smoke.moe, capacity_factor=0.0))
    cases = {"granite-moe-3b-a800m": dropless,
             "deepseek-moe-16b": smoke}
    monkeypatch.setattr(configs, "get_config", lambda a: cases[a])
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: Mesh(data=1, model=3))
    for arch, match in (("granite-moe-3b-a800m", "dropless"),
                        ("deepseek-moe-16b", "does not divide")):
        out = tmp_path / f"{arch}.json"
        rc = dryrun.main(["--arch", arch, "--shape", "train_4k", "--json",
                          str(out)])
        res = json.loads(out.read_text())
        assert rc == 1 and res["results"] == []
        (fail,) = res["failures"]
        assert fail["arch"] == arch and match in fail["error"]
        text = capsys.readouterr().out
        assert f"[FAIL] {arch} x train_4k @ data=1 x model=3" in text
        assert "0 cells OK, 1 failed" in text
    assert not dist.is_initialized()


@pytest.mark.slow
def test_cli_full_size_cell_on_the_production_mesh(tmp_path):
    """``--arch llama3-8b --shape train_4k`` on (data 16, model 16): one
    cell OK, the report's lines against the H100's constants, rank 0's
    step within 80 GB, and no real storage for weights or activations
    (the process's peak resident set far below the 19 GB of rank 0's
    weights and moments)."""
    out = tmp_path / "cell.json"
    argv = ["dryrun", "--arch", "llama3-8b", "--shape", "train_4k", "--json",
            str(out)]
    code = ("import resource, runpy, sys\n"
            f"sys.argv = {argv!r}\n"
            "try:\n"
            "    runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "print('maxrss', resource.getrusage(resource.RUSAGE_SELF)"
            ".ru_maxrss, file=sys.stderr)\n"
            "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=tp_ranks.env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "1 cells OK, 0 failed" in proc.stdout
    assert "[llama3-8b x train_4k @ data=16 x model=16]" in proc.stdout
    (r,), fails = json.loads(out.read_text()).values()
    assert fails == []
    assert r["compute_s"] == pytest.approx(
        r["hlo_gflops"] * 1e9 / dryrun.PEAK_FLOPS, rel=1e-12)
    assert r["collective_s"] == pytest.approx(
        r["collective_gbytes"] * 1e9 / dryrun.LINK_BW, rel=1e-12)
    assert 10e9 < r["arg_bytes_per_device"] < r["bytes_per_device"] < 80e9
    assert r["kernel_calls"] == {
        "flash_fwd_sm90": 2 * 32 * 4, "flash_bwd_delta": 32 * 4,
        "flash_bwd_dq_sm90": 32 * 4, "flash_bwd_dkv_sm90": 32 * 4}
    assert r["raw_uncorrected"] == pytest.approx(
        {"flops": r["hlo_gflops"] * 1e9, "bytes": r["hlo_gbytes"] * 1e9,
         "coll": r["collective_gbytes"] * 1e9}, rel=1e-12)
    rss_kib = int(proc.stderr.split("maxrss")[-1].split()[0])
    assert rss_kib * 1024 < 4e9


if __name__ == "__main__":
    tp_ranks.child({"coll": _coll_job}, sys.argv[1], int(sys.argv[2]),
                   int(sys.argv[3]), sys.argv[4])
