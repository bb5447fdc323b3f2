"""The MoE FFN over a mesh's model axis (``models/moe.py`` with ``mesh=``:
TP-experts and expert parallelism), served and trained on (data, model)
meshes, against the JAX package.

Ranks are subprocesses over gloo (``file://`` rendezvous) running this
file (``_child``), joined with a timeout.  The reference's own mesh path
runs in ONE more subprocess (``_oracle``), which sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before it imports
``jax`` and writes every JAX number of this file to an ``.npz``.  Smoke
deepseek-moe-16b (8 experts, top-2, d_expert 32, 2 shared experts of 64:
the TP-experts cases) and smoke granite-moe-3b-a800m with
``expert_mode="ep"`` (8 experts, top-2, d_expert 32: 4 or 2 whole experts
a rank), weights from JAX's ``init_params(PRNGKey(0))``, policy ``full``:

  * ``moe_ffn`` alone on 2 and 4 ranks, layer 0's weights cut by
    ``transformer.shard_fn``, x (2, 16, 64): capacity TP (cf 1.25: capacity
    8 rows an expert, some assignments drop), dropless TP (cf 0), capacity
    EP (the reference's ``in_range`` dispatch) and dropless under an EP
    config (each rank's own experts; the reference runs TP-experts there).
    The output and aux against JAX's meshless ``moe_ffn`` and against the
    reference's ``moe_ffn(mesh=)``; the gradients of x and of this rank's
    block of every leaf (of ``sum(out * g) + 0.37 aux``) against the slices
    of ``jax.grad`` of the meshless FFN; the router's gradient bit-equal
    across ranks;
  * the train step, 3 AdamW steps: deepseek TP on (1, 2) and granite EP on
    (1, 4) against JAX's meshless ``build_train_step`` at the global batch
    (4 x 32); deepseek TP on (2, 2), whose capacity and aux are per data
    shard (as the reference's), its step-1 loss and gradients against the
    reference's ``loss_fn(mesh=(2, 2))`` and ``jax.grad`` of it, its later
    steps against the port's own (2, 1) step; on every mesh the replicated
    leaves (the router, the norms) bit-equal across ranks, gradients and
    parameters;
  * ``ServeEngine(mesh=)`` on (1, 2) (deepseek TP, heads mode) and (1, 4)
    (granite EP, sequence mode: 2 KV heads): greedy streams token-exact
    against JAX's meshless engine (``kv_backend="ref"``) on a seeded trace;
  * the placement (TP on F, EP on E, the router replicated), the refusal
    of a leaf whose split dim does not divide the model axis, and the CLIs
    under torchrun's environment (2 ranks, ``--device cpu --smoke --policy
    full``): ``launch/train.py --arch deepseek-moe-16b`` prints the (1, 2)
    banner with ``experts: tp``, its losses equal a 1-rank run's, its
    checkpoint holds the global arrays (a 1-rank save's leaves and
    fingerprint) and resumes at 1 rank and at (1, 4);
    ``launch/serve.py --engine --arch granite-moe-3b-a800m`` serves the
    1-rank streams; a model axis of 3 exits 2 naming the leaf.

Tolerances, with the largest value measured on this tree beside each:
``moe_ffn``'s output 1e-6 of the largest |value| against the meshless JAX
FFN (2.5e-7) and against the reference's mesh FFN (3.2e-7), its aux 1e-6
relative (equal); its gradients 1e-5 of each leaf's largest |gradient|
(4.0e-7); the train step's losses and grad norms 1e-5 relative to JAX's
(8.0e-8 / 4.5e-7), the final parameters 1e-4 of the largest parameter
(1.3e-5, the bound ``test_torch_tp_train.py`` holds the dense step to);
(2, 2)'s step-1 loss 1e-5 relative (7.9e-8) and gradients 1e-5 of each
leaf's largest (2.4e-6) against the reference's mesh (whose loss, 6.0303,
is not its meshless 6.0501), its losses and grad norms 1e-5 relative to
the (2, 1) step's (8.7e-8); the CLI's losses to the printed 4 decimals
(1.5e-4, as ``test_torch_tp_train.py``'s).
"""
from __future__ import annotations

import atexit
import dataclasses
import functools
import json
import os
import pathlib
import pickle
import re
import shutil
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
THIS = pathlib.Path(__file__).resolve()
DS, GR = "deepseek-moe-16b", "granite-moe-3b-a800m"
STEPS, B, S = 3, 4, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
FFN_X = (2, 16, 64)
AUX_W = 0.37
JOIN_S = 300
# moe_ffn's cases: (arch, expert_mode, capacity_factor)
FFN_CASES = {"tp_capacity": (DS, "tp", 1.25), "tp_dropless": (DS, "tp", 0.0),
             "ep_capacity": (GR, "ep", 1.25), "ep_dropless": (GR, "ep", 0.0)}
# the engine's trace (prompt length, arrival step) and settings
TRACE = [(5, 0), (9, 0), (13, 2), (3, 4), (7, 5)]
KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
          policy_name="full")


def _cfg(arch, mode="tp", cf=1.25, jax=False):
    if jax:
        from repro import configs
    else:
        from repro_torch import configs
    cfg = configs.smoke_config(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, expert_mode=mode, capacity_factor=cf))


def _train_cfg(arch, jax=False):
    return _cfg(arch, "ep" if arch == GR else "tp", jax=jax)


def _ffn_inputs():
    rng = np.random.default_rng(7)
    return (rng.standard_normal(FFN_X).astype(np.float32),
            rng.standard_normal(FFN_X).astype(np.float32))


def _batches(arch):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1].copy(),
                    "labels": toks[:, 1:].copy()})
    return out


def _trace():
    rng = np.random.default_rng(0)
    return [(rng.integers(1, 200, (pl,)).astype(np.int32), st)
            for pl, st in TRACE]


# --------------------------------------------------------------------------
# The reference's numbers, in one subprocess with 4 emulated devices.
# --------------------------------------------------------------------------
def _oracle(out_path):
    """Every JAX number of this file -> ``out_path`` (.npz): the meshless
    FFN's output, aux and gradients and the mesh FFN's output and aux for
    each case; the meshless train step's metrics and final parameters for
    each arch; the (2, 2) mesh's step-1 loss and gradients."""
    import jax
    import jax.numpy as jnp
    from repro.core.mixed_precision import LossScale
    from repro.launch.mesh import make_mesh
    from repro.models import moe as jmoe
    from repro.models import transformer as jtf
    from repro.optim import adamw as jadamw
    from repro.train.train_step import TrainConfig, build_train_step
    out = {}
    x, g = (jnp.asarray(a) for a in _ffn_inputs())
    for case, (arch, mode, cf) in FFN_CASES.items():
        jcfg = _cfg(arch, mode, cf, jax=True)
        p = jax.tree.map(lambda a: a[0], jtf.init_params(
            jcfg, jax.random.PRNGKey(0))["blocks"]["ffn"])

        def obj(p, x, jcfg=jcfg):
            y, aux = jmoe.moe_ffn(p, x, jcfg)
            return jnp.sum(y * g) + AUX_W * aux, (y, aux)

        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            obj, argnums=(0, 1), has_aux=True))(p, x)
        out[f"{case}/out"], out[f"{case}/aux"] = y, aux
        out[f"{case}/grad/x"] = gx
        for k, v in gp.items():
            out[f"{case}/grad/{k}"] = v
        for n in (2, 4):
            mesh = make_mesh((1, n), ("data", "model"))
            ym, auxm = jax.jit(lambda p, x, jcfg=jcfg, mesh=mesh:
                               jmoe.moe_ffn(p, x, jcfg, mesh=mesh))(p, x)
            out[f"{case}/mesh{n}/out"], out[f"{case}/mesh{n}/aux"] = ym, auxm
    for arch in (DS, GR):
        jcfg = _train_cfg(arch, jax=True)
        params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        step = jax.jit(build_train_step(jcfg, TrainConfig(
            policy="full", opt=jadamw.AdamWConfig(**OPT))))
        opt, ls = jadamw.init(params), LossScale.noop()
        for i, b in enumerate(_batches(arch)):
            params, opt, ls, m = step(params, opt, ls, {
                k: jnp.asarray(v) for k, v in b.items()})
            for k in ("loss", "grad_norm"):
                out[f"step/{arch}/{i}/{k}"] = m[k]
        for path, v in jax.tree_util.tree_leaves_with_path(params):
            out[f"final/{arch}/{jax.tree_util.keystr(path)}"] = v
    jcfg = _train_cfg(DS, jax=True)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batches(DS)[0].items()}
    mesh = make_mesh((2, 2), ("data", "model"))
    for name, m in (("mesh22", mesh), ("meshless", None)):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, m=m: jtf.loss_fn(p, jcfg, batch, mesh=m),
            has_aux=True))(params)
        out[f"{name}/loss"] = loss
        for path, v in jax.tree_util.tree_leaves_with_path(grads):
            out[f"{name}/grad/{jax.tree_util.keystr(path)}"] = v
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


@functools.lru_cache(maxsize=None)
def _tmp() -> pathlib.Path:
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="moe_tp_"))
    atexit.register(shutil.rmtree, tmp, True)
    return tmp


@functools.lru_cache(maxsize=None)
def _oracle_proc():
    path = _tmp() / "oracle.npz"
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return path, subprocess.Popen(
        [sys.executable, str(THIS), "oracle", str(path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@functools.lru_cache(maxsize=None)
def _ref() -> dict:
    path, proc = _oracle_proc()
    (rc, _, err), = _join([proc])
    assert rc == 0, err[-3000:]
    with np.load(path) as z:
        return dict(z)


def _tree_named(prefix: str) -> dict:
    """{port parameter name: array} of the oracle's flattened JAX tree
    under ``prefix`` (its keys ``jax.tree_util.keystr`` paths)."""
    from repro_torch.models import bridge
    tree: dict = {}
    for k, v in _ref().items():
        if not k.startswith(prefix):
            continue
        node, keys = tree, re.findall(r"\['([^']+)'\]", k[len(prefix):])
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = v
    return bridge.from_jax_tree(tree)


@functools.lru_cache(maxsize=None)
def _jax_tree(arch):
    import jax
    from repro.models import transformer as jtf
    return jax.tree.map(np.asarray, jtf.init_params(
        _train_cfg(arch, jax=True), jax.random.PRNGKey(0)))


# --------------------------------------------------------------------------
# The ranks (run in subprocesses: ``python test_torch_moe_tp.py ...``).
# --------------------------------------------------------------------------
def _job_ffn(rank, world, trees, engine_tree, engine_arch):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe, transformer
    from repro_torch.serve import ServeEngine, TraceRequest
    mesh = Mesh(data=1, model=world)
    x, g = (torch.from_numpy(a) for a in _ffn_inputs())
    out = {}
    for case, (arch, mode, cf) in FFN_CASES.items():
        cfg = _cfg(arch, mode, cf)
        cut = transformer.shard_fn(cfg, mesh)
        w = {k: cut(f"blocks.0.ffn.{k}", torch.from_numpy(v[0].copy()))
             .requires_grad_() for k, v in trees[arch].items()}
        xr = x.clone().requires_grad_()
        y, aux = moe.moe_ffn(w, xr, cfg, mesh=mesh)
        ((y * g).sum() + AUX_W * aux).backward()
        out[case] = {"out": y.detach().numpy(), "aux": float(aux),
                     "layout": moe.expert_layout(w, cfg, mesh),
                     "grad": {"x": xr.grad.numpy(),
                              **{k: v.grad.numpy() for k, v in w.items()}}}
    from repro_torch.models import bridge
    cfg = _train_cfg(engine_arch)
    model = bridge.load_jax_params(cfg, engine_tree, device="cpu", mesh=mesh)
    eng = ServeEngine(model, cfg, mesh=mesh, **KW)
    eng.warmup()
    summary = eng.run([TraceRequest(prompt=p, max_new_tokens=6,
                                    arrival_step=st) for p, st in _trace()])
    out["engine"] = {"tokens": {r.rid: list(r.tokens)
                                for r in eng._requests_done},
                     "n_done": summary["n_done"], "audit": eng.pool.audit(),
                     "occupancy": eng.pool.occupancy}
    return out


def _keep_first_grads():
    """Wrap ``adamw.update`` so the first call's gradients (the step's,
    after its reductions) are kept; -> the list they land in."""
    from repro_torch.optim import adamw
    seen, real = [], adamw.update

    def update(cfg, grads, *args, **kwargs):
        if not seen:
            seen.append({n: g.detach().clone() for n, g in grads.items()})
        return real(cfg, grads, *args, **kwargs)

    adamw.update = update
    return seen


def _job_train(rank, world, arch, tree, shape):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import bridge
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (TrainConfig, init_loss_scale,
                                              make_train_step)
    cfg = _train_cfg(arch)
    mesh = Mesh(data=shape[0], model=shape[1])
    model = bridge.load_jax_params(cfg, tree, device="cpu",
                                   mesh=mesh).requires_grad_()
    opt = adamw.init(dict(model.named_parameters()))
    tc = TrainConfig(policy="full", opt=adamw.AdamWConfig(**OPT))
    seen = _keep_first_grads()
    step, tc = make_train_step(cfg, tc, {"tokens": torch.empty(
        (B, S), dtype=torch.int32, device="meta")}, mesh=mesh)
    ls = init_loss_scale(tc, "cpu")
    metrics = []
    for b in _batches(arch):
        model, opt, ls, m = step(model, opt, ls, {
            k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "placement": step.placement,
            "grads1": {n: g.numpy() for n, g in seen[0].items()},
            "local": {n: p.detach().numpy().copy()
                      for n, p in model.named_parameters()},
            "global": bridge.export_params(model, mesh=mesh)}


def _child(job_path, rank, world, init_file):
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        fn = {"ffn": _job_ffn, "train": _job_train}[job["kind"]]
        out = fn(rank, world, **job["args"])
        dist.barrier()           # no rank tears gloo down under another
    finally:
        dist.destroy_process_group()
    with open(f"{job_path}.{rank}", "wb") as f:
        pickle.dump(out, f)


def _cli_child(out_path, argv):
    """``launch.serve.main(argv)`` with the engine's finished streams
    written to ``out_path.<rank>``."""
    from repro_torch.serve import engine as engine_mod
    run = engine_mod.ServeEngine.run

    def recording_run(self, trace):
        summary = run(self, trace)
        rank = int(os.environ.get("RANK", "0"))
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump({r.rid: list(r.tokens)
                         for r in self._requests_done}, f)
        return summary

    engine_mod.ServeEngine.run = recording_run
    from repro_torch.launch import serve
    return serve.main(argv)


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu", **extra)


def _join(procs):
    """Wait for every process, each with a timeout; kill them all if one
    hangs.  -> [(returncode, stdout, stderr)]."""
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=JOIN_S)
            outs.append((p.returncode, o, e))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a process did not finish within {JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _spawn(kind, world, **args) -> list:
    tmp = pathlib.Path(tempfile.mkdtemp(dir=_tmp()))
    job = tmp / "job"
    with open(job, "wb") as f:
        pickle.dump({"kind": kind, "args": args}, f)
    procs = [subprocess.Popen(
        [sys.executable, str(THIS), str(job), str(r), str(world),
         str(tmp / "init")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    for r, (rc, _, err) in enumerate(_join(procs)):
        assert rc == 0, f"rank {r}: {err[-3000:]}"
    outs = []
    for r in range(world):
        with open(f"{job}.{r}", "rb") as f:
            outs.append(pickle.load(f))
    return outs


@functools.lru_cache(maxsize=None)
def _ffn_ranks(world):
    _oracle_proc()                          # the reference starts meanwhile
    trees = {arch: _jax_tree(arch)["blocks"]["ffn"] for arch in (DS, GR)}
    arch = DS if world == 2 else GR
    return _spawn("ffn", world, trees=trees, engine_tree=_jax_tree(arch),
                  engine_arch=arch)


@functools.lru_cache(maxsize=None)
def _train_ranks(arch, shape):
    _oracle_proc()
    return _spawn("train", shape[0] * shape[1], arch=arch,
                  tree=_jax_tree(arch), shape=shape)


@functools.lru_cache(maxsize=None)
def _jax_engine(arch):
    """JAX's meshless engine's streams on the trace (the MoE ignores
    ``expert_mode`` without a mesh)."""
    import jax
    from repro.models import transformer as jtf
    from repro.serve import ServeEngine as JServeEngine
    from repro.serve.trace import TraceRequest as JTrace
    jcfg = _train_cfg(arch, jax=True)
    eng = JServeEngine(jtf.init_params(jcfg, jax.random.PRNGKey(0)), jcfg,
                       kv_backend="ref", **KW)
    eng.warmup()
    eng.run([JTrace(prompt=list(p), max_new_tokens=6, arrival_step=st)
             for p, st in _trace()])
    return {r.rid: [int(t) for t in r.tokens] for r in eng._requests_done}


def _block(x, spec, shape, rank):
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh, coords
    mesh = Mesh(data=shape[0], model=shape[1])
    return shd.shard_leaf(x, spec, mesh, coords(mesh, rank))


def _replicated(spec) -> bool:
    return all(e is None for e in spec)


# --------------------------------------------------------------------------
# moe_ffn alone.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(FFN_CASES))
def test_ffn_matches_jax(case, world):
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh
    ref = _ref()
    arch, mode, cf = FFN_CASES[case]
    cfg = _cfg(arch, mode, cf)
    mesh = Mesh(data=1, model=world)
    want = ref[f"{case}/out"]
    top = np.abs(want).max()
    ranks = _ffn_ranks(world)
    e_l = cfg.moe.num_experts // world
    for r, out in enumerate(ranks):
        assert out[case]["layout"] == ((mode, r * e_l) if mode == "ep"
                                       else ("tp", 0))
        # every rank returns the same sum of the partials
        np.testing.assert_array_equal(out[case]["out"], ranks[0][case]["out"])
        assert np.abs(out[case]["out"] - want).max() <= 1e-6 * top
        assert np.abs(out[case]["out"] - ref[f"{case}/mesh{world}/out"]
                      ).max() <= 1e-6 * top
        for aux in (ref[f"{case}/aux"], ref[f"{case}/mesh{world}/aux"]):
            assert abs(out[case]["aux"] - float(aux)) <= 1e-6 * abs(aux)
        for k, g in out[case]["grad"].items():
            whole = ref[f"{case}/grad/{k}"]
            spec = () if k == "x" else shd.param_specs(
                cfg, {f"blocks.0.ffn.{k}": whole.shape},
                mesh)[f"blocks.0.ffn.{k}"]
            if k in ("w_gate", "w_up", "w_down") or k.startswith("shared"):
                assert not _replicated(spec), k
            got_shape, want_block = g.shape, _block(whole, spec, (1, world), r)
            assert got_shape == want_block.shape, k
            assert np.abs(g - want_block).max() <= \
                1e-5 * np.abs(whole).max(), (k, r)
        # the router's gradient is whole on every rank, the same bits
        np.testing.assert_array_equal(out[case]["grad"]["router"],
                                      ranks[0][case]["grad"]["router"])


def test_expert_parallel_dispatch_keeps_the_meshless_assignments():
    """The capacity cases drop assignments (capacity 8 of the 32 tokens'
    64 assignments over 8 experts), so the EP dispatch's ``in_range``
    ranks are exercised."""
    from repro_torch.models import moe
    cfg = _cfg(DS)
    x, _ = _ffn_inputs()
    w = {k: torch.from_numpy(v[0].copy())
         for k, v in _jax_tree(DS)["blocks"]["ffn"].items()}
    _, top_i, _ = moe.router_topk(torch.from_numpy(x).reshape(-1, 64),
                                  w["router"], cfg.moe.top_k)
    cap = moe.capacity(32, cfg)
    _, keep = moe.dispatch_slots(top_i, 8, cap)
    kept = [moe.dispatch_slots(top_i - off, 2, cap)[1]
            for off in range(0, 8, 2)]
    assert cap == 8 and int((~keep).sum()) > 0
    # the ranks' kept assignments are the meshless ones, split by expert
    torch.testing.assert_close(sum(k.int() for k in kept), keep.int())


# --------------------------------------------------------------------------
# The train step.
# --------------------------------------------------------------------------
TRAIN = [pytest.param(DS, (1, 2), id="deepseek-tp-1x2"),
         pytest.param(GR, (1, 4), id="granite-ep-1x4")]


def _check_replicated(outs, specs):
    for out in outs:
        assert out["placement"] == specs
        for n, spec in specs.items():
            if _replicated(spec):          # whole on every rank, bit-equal
                np.testing.assert_array_equal(out["grads1"][n],
                                              outs[0]["grads1"][n])
                np.testing.assert_array_equal(out["local"][n],
                                              outs[0]["local"][n])


@pytest.mark.parametrize("arch,shape", TRAIN)
def test_train_step_matches_jax_meshless(arch, shape):
    ref = _ref()
    outs = _train_ranks(arch, shape)
    for out in outs:
        for i, m in enumerate(out["metrics"]):
            assert m["grads_finite"]
            for k in ("loss", "grad_norm"):
                want = float(ref[f"step/{arch}/{i}/{k}"])
                assert m[k] == pytest.approx(want, rel=1e-5), (i, k)
        assert out["metrics"] == outs[0]["metrics"]
    assert all(out["global"] is None for out in outs[1:])
    from repro_torch.models import bridge
    got = bridge.from_jax_tree(outs[0]["global"])
    want = _tree_named(f"final/{arch}/")
    assert got.keys() == want.keys()
    top = max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= 1e-4 * top, k
    specs = outs[0]["placement"]
    mid = "blocks.1.ffn"
    if arch == GR:                          # EP: 2 whole experts a rank
        assert specs[f"{mid}.w_gate"] == ("model", None, None)
        assert outs[0]["local"][f"{mid}.w_gate"].shape[0] == 2
    else:                                   # TP: every expert's F / 2
        assert specs[f"{mid}.w_gate"] == (None, None, "model")
        assert specs[f"{mid}.shared_down"] == ("model", None)
    assert specs[f"{mid}.router"] == ()
    _check_replicated(outs, specs)


def test_train_step_2x2_matches_reference_mesh():
    """Capacity and aux per data shard: the reference's (2, 2) loss is not
    its meshless one; the port's (2, 2) step-1 loss and gradients are the
    reference mesh's, its later steps the port's own (2, 1) step's."""
    ref = _ref()
    outs = _train_ranks(DS, (2, 2))
    dp = _train_ranks(DS, (2, 1))
    loss = float(ref["mesh22/loss"])
    assert abs(loss - float(ref["meshless/loss"])) > 1e-3 * loss
    for out in outs:
        assert out["metrics"][0]["loss"] == pytest.approx(loss, rel=1e-5)
        for m, w in zip(out["metrics"], dp[0]["metrics"]):
            for k in ("loss", "grad_norm"):
                assert m[k] == pytest.approx(w[k], rel=1e-5), k
    grads = _tree_named("mesh22/grad/")
    specs = outs[0]["placement"]
    for r, out in enumerate(outs):
        assert out["grads1"].keys() == grads.keys()
        for n, g in out["grads1"].items():
            want = _block(grads[n], specs[n], (2, 2), r)
            assert g.shape == want.shape, n
            assert np.abs(g - want).max() <= 1e-5 * np.abs(grads[n]).max(), n
    # the model groups (ranks 0-1, 2-3) hold the same blocks after the steps
    for n in outs[0]["local"]:
        np.testing.assert_array_equal(outs[0]["local"][n], outs[2]["local"][n])
        np.testing.assert_array_equal(outs[1]["local"][n], outs[3]["local"][n])
    _check_replicated(outs, specs)


# --------------------------------------------------------------------------
# Serving.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("world", [pytest.param(2, id="deepseek-tp-1x2"),
                                   pytest.param(4, id="granite-ep-1x4")])
def test_engine_token_exact_against_jax(world):
    want = _jax_engine(DS if world == 2 else GR)
    assert len(want) == len(TRACE)
    for out in _ffn_ranks(world):
        e = out["engine"]
        assert e["tokens"] == want
        assert e["n_done"] == len(TRACE) and e["occupancy"] == 0
        assert e["audit"]["allocs"] == e["audit"]["frees"]


# --------------------------------------------------------------------------
# Placement and refusal.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["tp", "ep"])
def test_placement_cuts_the_experts(mode):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer
    cfg = _cfg(DS, mode)
    specs = transformer.param_placement(cfg, Mesh(data=1, model=2))
    ffn = {n.split(".")[-1]: s for n, s in specs.items()
           if n.startswith("blocks.0.ffn.")}
    expert = ("model", None, None) if mode == "ep" else None
    assert ffn["w_gate"] == (expert or (None, None, "model"))
    assert ffn["w_up"] == (expert or (None, None, "model"))
    assert ffn["w_down"] == (expert or (None, "model", None))
    assert ffn["shared_gate"] == (None, "model")
    assert ffn["shared_down"] == ("model", None)
    assert ffn["router"] == ()


@pytest.mark.parametrize("mode,leaf", [("tp", "F of 32"), ("ep", "E of 8")])
def test_refuses_a_leaf_that_does_not_divide(mode, leaf):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer
    from repro_torch.train import train_step as ts
    cfg = _cfg(DS, mode)
    mesh = Mesh(data=1, model=3)
    for fn in (lambda: transformer.check_mesh(cfg, mesh),
               lambda: transformer.init_params(cfg, 0, device="cpu",
                                               mesh=mesh),
               lambda: ts.build_train_step(cfg, ts.TrainConfig(), mesh=mesh)):
        with pytest.raises(ValueError, match=f"ffn.w_gate splits its {leaf}"):
            fn()


# --------------------------------------------------------------------------
# The CLIs under torchrun's environment.
# --------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world, cmd):
    env = [{}] if world == 1 else [dict(
        RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
        MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        for port in [str(_free_port())] for r in range(world)]
    return _join([subprocess.Popen(cmd, env=_env(**e), text=True,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE) for e in env])


def _train_cli(world, ckpt, *args):
    return _launch(world, [
        sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
        "--smoke", "--arch", DS, "--policy", "full", "--batch", "4",
        "--seq", "16", "--log-every", "1", "--ckpt-every", "2",
        "--ckpt-dir", str(ckpt), *args])


def _losses(stdout):
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"step\s+(\d+) loss (\S+)", stdout)}


def _ok(outs):
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return outs[0][1]


def _manifest(ckpt, step=2):
    return json.loads((ckpt / f"step_{step:08d}" / "manifest.json")
                      .read_text())


def test_cli_trains_and_reshards_the_moe(tmp_path):
    tp, one = tmp_path / "tp", tmp_path / "one"
    out_tp = _ok(_train_cli(2, tp, "--steps", "2", "--fresh"))
    out_one = _ok(_train_cli(1, one, "--steps", "2", "--fresh"))
    assert "mesh: data=1 x model=2 (2 devices), experts: tp" in out_tp
    alone = _losses(_ok(_train_cli(1, tmp_path / "whole", "--steps", "4",
                                   "--fresh")))
    assert sorted(alone) == [0, 1, 2, 3]
    for step, loss in {**_losses(out_tp), **_losses(out_one)}.items():
        assert abs(loss - alone[step]) <= 1.5e-4, (step, loss)
    # the (1, 2) checkpoint holds the global arrays: a 1-rank save's tree
    m_tp, m_one = _manifest(tp), _manifest(one)
    assert m_tp["leaves"] == m_one["leaves"]
    assert m_tp["fingerprint"] == m_one["fingerprint"]
    # it resumes at 1 rank and at (1, 4), each continuing the whole run
    for i, (world, banner) in enumerate(((1, "data=1 x model=1"),
                                         (4, "data=1 x model=4"))):
        dst = tmp_path / f"resume{i}"
        shutil.copytree(tp, dst)
        out = _ok(_train_cli(world, dst, "--steps", "4"))
        assert f"mesh: {banner}" in out
        assert "resumed from step 2" in out, out
        got = _losses(out)
        assert sorted(got) == [2, 3]
        for step, loss in got.items():
            assert abs(loss - alone[step]) <= 1.5e-4, (i, step, loss)


def test_cli_refuses_a_model_axis_that_splits_no_leaf(tmp_path):
    outs = _train_cli(3, tmp_path / "ck", "--max-model", "3", "--steps",
                      "1", "--fresh")
    assert [rc for rc, _, _ in outs] == [2, 2, 2]
    err = outs[0][2]
    assert "mesh: data=1 x model=3" in err and "ffn.w_gate" in err
    assert "--max-model 1" in err


def _serve_cli(world, out_path):
    return _launch(world, [
        sys.executable, str(THIS), "cli", str(out_path), "--device", "cpu",
        "--smoke", "--engine", "--arch", GR, "--policy", "full",
        "--requests", "6"])


def test_cli_serves_the_moe_on_two_ranks(tmp_path):
    two, one = tmp_path / "two", tmp_path / "one"
    out = _ok(_serve_cli(2, two))
    assert "mesh: data=1 x model=2 (2 devices)" in out
    assert "experts: tp" in out
    _ok(_serve_cli(1, one))
    streams = {}
    for name, path, ranks in (("one", one, 1), ("two", two, 2)):
        for r in range(ranks):
            with open(f"{path}.{r}", "rb") as f:
                streams[name, r] = pickle.load(f)
    assert len(streams["one", 0]) == 6
    assert streams["two", 0] == streams["one", 0]
    assert streams["two", 1] == streams["one", 0]


if __name__ == "__main__":
    if sys.argv[1] == "oracle":
        _oracle(sys.argv[2])
    elif sys.argv[1] == "cli":
        raise SystemExit(_cli_child(sys.argv[2], sys.argv[3:]))
    else:
        _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
