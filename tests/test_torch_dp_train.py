"""Data-parallel training over ``torch.distributed`` process groups
(gloo, ranks spawned as processes on the CPU) against the JAX package.

The oracle is JAX's meshless ``build_train_step`` at the GLOBAL batch,
run in this process: the reference asserts that its sharded step equals
its single-device step (``tests/test_mesh_parallel.py`` ``TestTrainParity``),
and its own mesh tests are too slow on emulated devices to run here.

  * 2 ranks, policy ``full``, 3 AdamW steps, with and without ``accum``:
    losses, grad norms and the final parameters against JAX's, every
    rank holding the same replica; then a NaN in one rank's gradient
    (a hook on rank 1 only) makes both ranks skip;
  * ``compressed_psum_grads`` over 2 and 4 ranks: the mean within the
    int8 step, unbiased over seeds, the ranks' rounding decorrelated,
    the payload a quarter of the f32 bytes plus the scales; and
    ``device_mesh`` over the group, a tensor placed by its batch spec
    (``to_placements``) holding each rank's rows;
  * ``launch.train`` under torchrun's environment: 2 ranks with
    ``--max-model 1`` print the mesh banner and train, a checkpoint they
    write resumes at 1 rank with the losses of an uninterrupted 1-rank
    run, and 2 ranks without ``--max-model 1`` make a model axis of 2:
    the (1, 2) mesh trains (``tests/test_torch_tp_train.py`` holds its
    numbers), an MoE arch there too (``tests/test_torch_moe_tp.py``).

Tolerances: losses and grad norms 1e-5 relative to JAX's (two f32
implementations that sum in different orders; measured <= 4e-7).  The
final parameters 1e-5 of the largest parameter against the port's own
meshless step at the global batch (the DP reduction's own error:
measured 6.9e-7 / 1.4e-6 without / with accum), and 1e-4 of it against
JAX's, the bound ``test_torch_train.py`` holds the single-device step
to: the meshless port already differs from JAX by 2.1e-5 of it on these
batches, AdamW dividing each near-zero gradient by its own scale.  The seed-averaged compressed mean
(30 seeds x 4 ranks, 60 x 2) within 2e-3, the reference's bound for 30
seeds x 8 ranks: the averaged error's spread goes as 1 / sqrt(seeds x
ranks), and seeds x ranks here is 120 where the reference's is 240, with
the reference's gradient scale (N(0, 0.4^2)).

Each rank is a subprocess running this file (``_child``), one thread,
joined with a timeout: a hung rank fails its test, not the suite.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import pickle
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
THIS = pathlib.Path(__file__).resolve()
ARCH = "llama3-8b"
STEPS, B, S = 3, 4, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
JOIN_S = 240


# --------------------------------------------------------------------------
# The ranks (run in subprocesses: ``python test_torch_dp_train.py ...``).
# --------------------------------------------------------------------------
def _job_train(rank, world, tree, policy, accum, batches, nan_step):
    from repro_torch import configs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import bridge
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (TrainConfig, build_train_step,
                                              init_loss_scale,
                                              make_train_step)
    cfg = configs.smoke_config(ARCH)
    mesh = Mesh(data=world, model=1)
    model = bridge.load_jax_params(cfg, tree, device="cpu").requires_grad_()
    opt = adamw.init(dict(model.named_parameters()))
    tc = TrainConfig(policy=policy, accum=accum,
                     opt=adamw.AdamWConfig(**OPT))
    sds = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    step, tc = make_train_step(cfg, tc, sds, mesh=mesh)
    ls = init_loss_scale(tc, "cpu")
    out = {"metrics": []}
    for t, lab in batches[:STEPS]:
        model, opt, ls, m = step(model, opt, ls, {
            "tokens": torch.from_numpy(t), "labels": torch.from_numpy(lab)})
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["params"] = bridge.export_params(model)
    out["count"] = int(opt.count)
    if nan_step:
        skip_step = build_train_step(
            cfg, dataclasses.replace(tc, skip_nonfinite=True), mesh=mesh)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        hook = None
        if rank == 1:
            hook = dict(model.named_parameters())[
                "blocks.0.attn.wq"].register_hook(
                    lambda g: g * float("nan"))
        t, lab = batches[STEPS]
        model, opt, ls, m = skip_step(model, opt, ls, {
            "tokens": torch.from_numpy(t), "labels": torch.from_numpy(lab)})
        if hook is not None:
            hook.remove()
        out["nan"] = {
            "grads_finite": bool(m["grads_finite"]),
            "count": int(opt.count),
            "unchanged": all(torch.equal(p.detach(), before[n])
                             for n, p in model.named_parameters())}
    return out


def _grads(rank, same):
    rng = np.random.default_rng(3 if same else 3 + rank)
    return {"w": torch.from_numpy((rng.normal(size=(32, 16)) * 0.4)
                                  .astype(np.float32)),
            "b": torch.from_numpy((rng.normal(size=(16,)) * 0.4)
                                  .astype(np.float32))}


def _job_psum(rank, world, seeds):
    from repro_torch.distributed import collectives
    from repro_torch.optim import compression
    g = _grads(rank, same=False)
    plain = {k: v.clone() for k, v in g.items()}
    for v in plain.values():
        dist.all_reduce(v)
        v /= world
    scales = {k: torch.zeros(world) for k in g}
    for k, (_, s) in collectives.rank_payload(g, 0, rank).items():
        scales[k][rank] = s
    for v in scales.values():
        dist.all_reduce(v)
    first = collectives.compressed_psum_grads(g, seed=0)
    acc = None
    for seed in range(seeds):
        o = collectives.compressed_psum_grads(g, seed=seed)
        acc = o if acc is None else {k: acc[k] + o[k] for k in o}
    # every rank holds the same gradient: decorrelated rounding
    same = _grads(rank, same=True)
    mine = {k: compression.dequantize_int8(*p) for k, p in
            collectives.rank_payload(same, 5, rank).items()}
    codes = collectives.rank_payload(same, 5, rank)["w"][0].float()
    all_codes = [torch.zeros_like(codes) for _ in range(world)]
    dist.all_gather(all_codes, codes)
    mean_same = collectives.compressed_psum_grads(same, seed=5)
    payload = collectives.rank_payload(g, 0, rank)
    # the mesh over this group, and a batch-like tensor placed by its spec
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import Mesh, device_mesh
    dm = device_mesh(Mesh(data=world, model=1), "cpu")
    rows = torch.arange(world * 2 * 3, dtype=torch.float32).reshape(-1, 3)
    placed = distribute_tensor(rows, dm, sharding.to_placements(
        dm, sharding.batch_specs(None, {"tokens": rows}, Mesh(
            data=world, model=1))["tokens"]))
    return {
        "mesh_dims": tuple(dm.mesh_dim_names),
        "local_rows": placed.to_local().numpy(),
        "first": {k: v.numpy() for k, v in first.items()},
        "avg": {k: (v / seeds).numpy() for k, v in acc.items()},
        "plain": {k: v.numpy() for k, v in plain.items()},
        "scales": {k: v.numpy() for k, v in scales.items()},
        "same_codes_differ": any(not torch.equal(all_codes[0], c)
                                 for c in all_codes[1:]),
        "rms_mean": {k: float(((mean_same[k] - same[k]) ** 2).mean().sqrt())
                     for k in same},
        "rms_one": {k: float(((mine[k] - same[k]) ** 2).mean().sqrt())
                    for k in same},
        "payload_bytes": compression.payload_bytes(payload),
        "f32_bytes": sum(v.numel() * 4 for v in g.values()),
    }


def _child(job_path, rank, world, init_file):
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        fn = {"train": _job_train, "psum": _job_psum}[job["kind"]]
        out = fn(rank, world, **job["args"])
    finally:
        dist.destroy_process_group()
    with open(f"{job_path}.{rank}", "wb") as f:
        pickle.dump(out, f)


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu", **extra)


def _join(procs):
    """Wait for every process, each with a timeout; kill them all if one
    hangs or fails.  -> [(returncode, stdout, stderr)]."""
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=JOIN_S)
            outs.append((p.returncode, o, e))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank did not finish within {JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _spawn(tmp_path, kind, world, **args) -> list:
    job = tmp_path / f"{kind}.job"
    with open(job, "wb") as f:
        pickle.dump({"kind": kind, "args": args}, f)
    init = tmp_path / f"{kind}.init"
    procs = [subprocess.Popen(
        [sys.executable, str(THIS), str(job), str(r), str(world), str(init)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    for r, (rc, _, err) in enumerate(_join(procs)):
        assert rc == 0, f"rank {r}: {err[-3000:]}"
    outs = []
    for r in range(world):
        with open(f"{job}.{r}", "rb") as f:
            outs.append(pickle.load(f))
    return outs


# --------------------------------------------------------------------------
# The tests.
# --------------------------------------------------------------------------
def _batches(vocab, n):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append((toks[:, :-1].copy(), toks[:, 1:].copy()))
    return out


@pytest.fixture(scope="module")
def smoke():
    import jax
    from repro import configs as jconfigs
    from repro.models import transformer as jtf
    jcfg = jconfigs.smoke_config(ARCH)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, params, jax.tree.map(np.asarray, params)


def _jax_run(jcfg, params, policy, accum, batches):
    import jax
    import jax.numpy as jnp
    from repro.core.mixed_precision import LossScale
    from repro.optim import adamw as jadamw
    from repro.train.train_step import TrainConfig, build_train_step
    jcfg = dataclasses.replace(jcfg, attn_backend="interpret")
    step = jax.jit(build_train_step(jcfg, TrainConfig(
        policy=policy, accum=accum, opt=jadamw.AdamWConfig(**OPT))))
    opt, ls, metrics = jadamw.init(params), LossScale.noop(), []
    for t, lab in batches[:STEPS]:
        params, opt, ls, m = step(params, opt, ls, {
            "tokens": jnp.asarray(t), "labels": jnp.asarray(lab)})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, params)


def _port_run(tree, policy, accum, batches):
    """The port's meshless step at the global batch, in this process."""
    from repro_torch import configs
    from repro_torch.models import bridge
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (TrainConfig, build_train_step,
                                              init_loss_scale)
    cfg = configs.smoke_config(ARCH)
    model = bridge.load_jax_params(cfg, tree, device="cpu").requires_grad_()
    opt = adamw.init(dict(model.named_parameters()))
    tc = TrainConfig(policy=policy, accum=accum, opt=adamw.AdamWConfig(**OPT))
    step, ls = build_train_step(cfg, tc), init_loss_scale(tc, "cpu")
    for t, lab in batches[:STEPS]:
        model, opt, ls, _ = step(model, opt, ls, {
            "tokens": torch.from_numpy(t), "labels": torch.from_numpy(lab)})
    return bridge.export_params(model)


def _leaves(tree):
    import jax
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_step_matches_jax_meshless(smoke, tmp_path, accum):
    from repro_torch import configs
    jcfg, params, tree = smoke
    batches = _batches(configs.smoke_config(ARCH).vocab, STEPS + 1)
    outs = _spawn(tmp_path, "train", 2, tree=tree, policy="full",
                  accum=accum, batches=batches, nan_step=accum == 1)
    want, want_params = _jax_run(jcfg, params, "full", accum, batches)
    for out in outs:
        assert out["count"] == STEPS
        for m, jm in zip(out["metrics"], want):
            assert m["grads_finite"]
            assert m["lr"] == pytest.approx(jm["lr"], rel=1e-6)
            assert m["loss"] == pytest.approx(jm["loss"], rel=1e-5)
            assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-5)
    got0, got1, ref = (_leaves(outs[0]["params"]), _leaves(outs[1]["params"]),
                       _leaves(want_params))
    alone = _leaves(_port_run(tree, "full", accum, batches))
    assert got0.keys() == ref.keys()
    top = max(np.abs(v).max() for v in ref.values())
    for k, w in ref.items():
        np.testing.assert_array_equal(got0[k], got1[k])   # one replica
        assert np.abs(got0[k] - alone[k]).max() <= 1e-5 * top, k
        assert np.abs(got0[k] - w).max() <= 1e-4 * top, k
    # the ranks agree step by step: every metric is the global one
    assert outs[0]["metrics"] == outs[1]["metrics"]
    if accum == 1:
        for out in outs:        # a NaN on rank 1 only: both ranks skip
            assert out["nan"] == {"grads_finite": False, "count": STEPS,
                                  "unchanged": True}


@pytest.mark.parametrize("world,seeds", [(2, 60), (4, 30)])
def test_compressed_psum_grads(tmp_path, world, seeds):
    outs = _spawn(tmp_path, "psum", world, seeds=seeds)
    for out in outs[1:]:                   # every rank gets the same mean
        for k in out["first"]:
            np.testing.assert_array_equal(out["first"][k],
                                          outs[0]["first"][k])
    out = outs[0]
    for k, plain in out["plain"].items():
        # each rank's rounding moves a value by less than its int8 step
        step = out["scales"][k].mean()
        assert np.abs(out["first"][k] - plain).max() < step
        assert np.abs(out["avg"][k] - plain).max() < 2e-3      # unbiased
        # identical inputs, decorrelated noise: the mean over ranks rounds
        # better than one rank (1 / sqrt(world) in expectation)
        assert out["rms_mean"][k] < 0.85 * out["rms_one"][k]
    assert out["same_codes_differ"]
    for r, o in enumerate(outs):         # device_mesh and to_placements
        assert o["mesh_dims"] == ("data", "model")
        np.testing.assert_array_equal(
            o["local_rows"], np.arange(r * 6, r * 6 + 6, dtype=np.float32)
            .reshape(2, 3))
    n_leaves = len(out["plain"])
    assert out["payload_bytes"] == out["f32_bytes"] // 4 + 4 * n_leaves


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(world, tmp_path, *args):
    """``launch.train`` at ``world`` ranks under torchrun's environment
    (1 rank: no environment, as a plain run)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--smoke", "--policy", "full", "--batch", "4", "--seq",
           "16", "--log-every",
           "1", "--ckpt-dir", str(tmp_path / "ck"), *args]
    if world == 1:
        return _join([subprocess.Popen(cmd, env=_env(), text=True,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE)])[0]
    port = str(_free_port())
    procs = [subprocess.Popen(cmd, env=_env(
        RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
        MASTER_ADDR="127.0.0.1", MASTER_PORT=port), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(world)]
    return _join(procs)


def _losses(stdout):
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"step\s+(\d+) loss (\S+)", stdout)}


def test_cli_two_ranks_then_elastic_resume_at_one(tmp_path):
    r0, r1 = _cli(2, tmp_path, "--max-model", "1", "--steps", "2", "--fresh")
    assert r0[0] == 0 and r1[0] == 0, r0[2][-2000:] + r1[2][-2000:]
    assert "mesh: data=2 x model=1 (2 devices)" in r0[1]
    assert "step     1 loss" in r0[1] and "done" in r0[1]
    assert r1[1] == ""                      # rank 1 prints nothing
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002"]
    rc, out, err = _cli(1, tmp_path, "--steps", "4")
    assert rc == 0, err[-2000:]
    assert "mesh: data=1 x model=1 (1 devices)" in out
    assert "resumed from step 2 (data batch 2)" in out
    whole = tmp_path / "whole"
    rc, ref, err = _cli(1, whole, "--steps", "4", "--fresh")
    assert rc == 0, err[-2000:]
    dp, resumed, alone = _losses(r0[1]), _losses(out), _losses(ref)
    assert sorted(alone) == [0, 1, 2, 3] and sorted(resumed) == [2, 3]
    for step, loss in {**dp, **resumed}.items():
        # 4 decimals as printed; the DP sums differ in the last f32 digits
        assert abs(loss - alone[step]) <= 1.5e-4, (step, loss, alone[step])


def test_cli_two_ranks_need_max_model_one(tmp_path):
    # without --max-model 1, two ranks train on (data 1, model 2)
    outs = _cli(2, tmp_path, "--steps", "1", "--fresh")
    assert [rc for rc, _, _ in outs] == [0, 0], outs[0][2][-2000:]
    assert "mesh: data=1 x model=2 (2 devices)" in outs[0][1]
    assert "step     0 loss" in outs[0][1] and outs[1][1] == ""
    # an MoE arch there trains too, its experts split over the model axis
    outs = _cli(2, tmp_path / "moe", "--arch", "deepseek-moe-16b",
                "--steps", "1", "--fresh")
    assert [rc for rc, _, _ in outs] == [0, 0], outs[0][2][-2000:]
    assert "mesh: data=1 x model=2 (2 devices), experts: tp" in outs[0][1]
    assert "step     0 loss" in outs[0][1] and outs[1][1] == ""
    help_ = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                            "--help"], env=_env(), capture_output=True,
                           text=True, timeout=JOIN_S)
    text = " ".join(help_.stdout.split())
    assert "(data 1, model 2) under the default" in text
    assert "--max-model 1" in text


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
