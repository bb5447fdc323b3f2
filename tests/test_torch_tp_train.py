"""Tensor-parallel training over a (data, model) mesh (``train_step`` with
a model axis > 1, ``collectives.copy_to_model`` / ``reduce_from_model``,
``transformer.vocab_parallel_ce`` / ``loss_fn(mesh=)``, the sharded clip
norm of ``adamw.update``, the resharding checkpoints of ``launch/train.py``)
against the JAX package.

Ranks are subprocesses over gloo (``file://`` rendezvous) running this
file (``_child``), one thread each, joined with a timeout.  The
reference's own oracle (``tests/test_mesh_parallel.py`` ``TestTrainParity``:
a (4, 2) mesh's loss and gradients against the (1, 1) mesh's) needs 8
emulated devices and skips here, so the oracle is JAX's meshless
``build_train_step`` at the global batch, in this process, and the port's
own meshless step is a second one.  Smoke llama3-8b (4 / 2 heads of 16,
d_ff 128, vocab 256, 2 layers), policy ``full``, weights from JAX's
``init_params(PRNGKey(0))`` cut per rank by ``bridge.load_jax_params(
mesh=)``:

  * the TP step on (1, 2) (heads mode: one KV head a rank), (1, 4)
    (sequence mode: the 2 KV heads do not divide 4, the attention is
    whole on every rank, the FFN and the vocab split) and (2, 2) (4
    ranks, DP x TP), accum 1 and 2, 3 AdamW steps: losses and grad norms
    against JAX's, the final parameters gathered on rank 0 against JAX's
    and the port's meshless step's, each rank's step-1 gradients (what
    the step hands to AdamW) against the slices of the meshless step's,
    the replicated leaves (the norms; the attention in sequence mode)
    bit-equal across ranks, parameters and gradients; with accum 1 a NaN
    in rank 1's block of ``w_gate`` makes every rank skip the step;
  * qwen2-vl-2b's smoke config on (1, 2): the tied head (``embed.T``,
    whose rows take their gradient from the lookup and the head), patches
    and (3, B, S) M-RoPE positions (the batch of
    ``test_torch_mrope.py``'s train test), the same gates;
  * ``vocab_parallel_ce`` alone on 2 and 4 ranks, with a vocab of 250
    whose padded tail (250-255) lies in the last block: its NLL and the
    logits' gradient against ``_ce_terms`` on the whole logits; and
    ``loss_fn(mesh=)`` with ``ce_chunk`` 0 and 8 against the meshless
    ``loss_fn`` (the loss, every gradient against its slice);
  * ``copy_to_model`` / ``reduce_from_model`` on 2 ranks in f32 and bf16:
    forward and backward against the sums computed by hand, bit for bit;
  * ``launch/train.py`` ``train_state`` on every rank of (2, 1), (1, 2)
    and (2, 2): the global state's shapes on rank 0 alone, None on every
    other rank, and only rank 0's model group gathering (one gather a
    sharded leaf of the parameters and of each moment);
  * the CLI under torchrun's environment: 2 ranks with the default
    ``--max-model`` print the (1, 2) banner and their losses equal a
    1-rank run's to the printed 4 decimals (within 1.5e-4, as
    ``test_torch_dp_train.py``'s CLI test); their checkpoint holds the
    global arrays (the manifest's leaves and fingerprint a 1-rank save's,
    the parameters within 1e-4 of the largest, the moments within 1e-5
    of each leaf's largest); it resumes at 1 rank, at
    (2, 1) and at (1, 4), and a 1-rank checkpoint resumes at (1, 2), each
    continuing the uninterrupted run's losses; minicpm3-4b (MLA) on a
    model axis of 2 exits 2 naming MLA, and whisper-base (the encoder,
    whose frames this trainer's stream lacks) exits 2 on any mesh (the
    MoE archs train there: ``tests/test_torch_moe_tp.py``; the SSM archs
    too: ``tests/test_torch_ssm_tp.py``).

Tolerances, with the largest value measured on this tree beside each
(over every mesh, accum and arch above): losses and grad norms 1e-5
relative to JAX's (measured 1.6e-7 / 3.8e-7); the final parameters 1e-4
of the largest parameter against JAX's (1.5e-5), the bound
``test_torch_dp_train.py`` holds the DP step to, and 1e-5 of it against
the port's meshless step (9.2e-6: the row-parallel sums and the CE's
statistics add f32 partials in another order, and AdamW divides a
near-zero gradient by its own scale, so one such entry moves by a step's
fraction of ``lr``); the step-1 gradients 1e-5 of each leaf's largest
|gradient| (1.2e-6); the CE's NLL 1e-6 relative (9.3e-8) and its logits'
gradient 1e-6 absolute (1.8e-7; the gradients lie in [-1, 1]);
``loss_fn(mesh=)``'s loss 1e-6 relative (8.2e-8) and its gradients 1e-5
of each leaf's largest (1.1e-6).  The CLI's checkpoint against a 1-rank
one after 2 steps: parameters 1.2e-5 of the largest (bound 1e-4),
moments 1.7e-6 of each leaf's largest (bound 1e-5).
"""
from __future__ import annotations

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

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
THIS = pathlib.Path(__file__).resolve()
ARCH, QWEN = "llama3-8b", "qwen2-vl-2b"
STEPS, B, S = 3, 4, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
CE_VOCAB, CE_CHUNK = 250, 8
JOIN_S = 240


# --------------------------------------------------------------------------
# The ranks (run in subprocesses: ``python test_torch_tp_train.py ...``).
# --------------------------------------------------------------------------
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


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _train(arch, tree, accum, batches, mesh):
    """STEPS steps of ``make_train_step(mesh=)`` from ``tree`` (this
    rank's block of it on ``mesh``) -> (model, opt, step, metrics, the
    first step's gradients)."""
    from repro_torch import configs
    from repro_torch.models import bridge
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (TrainConfig, init_loss_scale,
                                              make_train_step)
    cfg = configs.smoke_config(arch)
    model = bridge.load_jax_params(cfg, tree, device="cpu",
                                   mesh=mesh).requires_grad_()
    opt = adamw.init(dict(model.named_parameters()))
    tc = TrainConfig(policy="full", accum=accum,
                     opt=adamw.AdamWConfig(**OPT))
    sds = {"tokens": torch.empty(batches[0]["tokens"].shape,
                                 dtype=torch.int32, device="meta")}
    seen = _keep_first_grads()
    step, tc = make_train_step(cfg, tc, sds, mesh=mesh)
    ls = init_loss_scale(tc, "cpu")
    metrics = []
    for b in batches[:STEPS]:
        model, opt, ls, m = step(model, opt, ls, _torch_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return model, opt, step, metrics, seen[0]


def _job_train(rank, world, arch, tree, accum, batches, shape, nan_step):
    from repro_torch import configs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import bridge
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (TrainConfig, build_train_step,
                                              init_loss_scale)
    mesh = Mesh(data=shape[0], model=shape[1])
    model, opt, step, metrics, grads1 = _train(arch, tree, accum, batches,
                                               mesh)
    out = {"metrics": metrics, "count": int(opt.count),
           "placement": step.placement,
           "grads1": {n: g.numpy() for n, g in grads1.items()},
           "local": {n: p.detach().numpy().copy()
                     for n, p in model.named_parameters()},
           "global": bridge.export_params(model, mesh=mesh)}
    if nan_step:
        cfg = configs.smoke_config(arch)
        tc = TrainConfig(policy="full", skip_nonfinite=True,
                         opt=adamw.AdamWConfig(**OPT))
        skip_step = build_train_step(cfg, tc, mesh=mesh)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        hook = None
        if rank == 1:                      # a sharded leaf, this rank only
            hook = dict(model.named_parameters())[
                "blocks.0.ffn.w_gate"].register_hook(
                    lambda g: g * float("nan"))
        model, opt, _, m = skip_step(model, opt, init_loss_scale(tc, "cpu"),
                                     _torch_batch(batches[STEPS]))
        if hook is not None:
            hook.remove()
        out["nan"] = {
            "grads_finite": bool(m["grads_finite"]),
            "count": int(opt.count),
            "unchanged": all(torch.equal(p.detach(), before[n])
                             for n, p in model.named_parameters())}
    return out


def _ce_cfg():
    from repro_torch import configs
    return dataclasses.replace(configs.smoke_config(ARCH), vocab=CE_VOCAB)


def _ce_batch():
    rng = np.random.default_rng(5)
    toks = rng.integers(0, CE_VOCAB, (2, 20 + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def _job_ce(rank, world, logits, labels, upstream):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer
    cfg = _ce_cfg()
    mesh = Mesh(data=1, model=world)
    v_l = cfg.padded_vocab // world
    block = torch.from_numpy(
        logits[..., rank * v_l:(rank + 1) * v_l].copy()).requires_grad_()
    nll = transformer.vocab_parallel_ce(
        transformer._mask_padded_vocab(block, cfg, offset=rank * v_l),
        torch.from_numpy(labels), mesh)
    (nll * torch.from_numpy(upstream)).sum().backward()
    out = {"nll": nll.detach().numpy(), "grad": block.grad.numpy()}
    for chunk in (0, CE_CHUNK):
        model = transformer.init_params(cfg, 3, device="cpu",
                                        mesh=mesh).requires_grad_()
        loss, _ = transformer.loss_fn(model, cfg, _torch_batch(_ce_batch()),
                                      ce_chunk=chunk, mesh=mesh)
        loss.backward()
        out[f"loss_{chunk}"] = {
            "loss": float(loss),
            "grads": {n: p.grad.numpy() for n, p in
                      model.named_parameters()}}
    return out


def _job_ops(rank, world):
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(data=1, model=world)
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        mine = np.random.default_rng(10 + rank)
        x = torch.from_numpy(mine.standard_normal((3, 5)).astype(
            np.float32)).to(dt).requires_grad_()
        w = torch.from_numpy(mine.standard_normal((3, 5)).astype(np.float32))
        y = collectives.reduce_from_model(x, mesh)
        (y.float() * w).sum().backward()
        shared = torch.from_numpy(np.random.default_rng(9).standard_normal(
            (3, 5)).astype(np.float32)).to(dt).requires_grad_()
        z = collectives.copy_to_model(shared, mesh)
        (z.float() * w).sum().backward()
        out[name] = {k: v.detach().float().numpy() for k, v in dict(
            x=x, w=w, y=y, x_grad=x.grad, shared=shared, z=z,
            shared_grad=shared.grad).items()}
    return out


def _job_save(rank, world, arch, shape):
    """``train_state`` on every rank of ``shape``, counting the model-axis
    gathers this rank takes part in."""
    from repro_torch import configs
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import init_state, train_state
    cfg = configs.smoke_config(arch)
    mesh = Mesh(data=shape[0], model=shape[1])
    model, opt = init_state(cfg, 0, "cpu", mesh)
    gathers, real = [], collectives.model_all_gather

    def counted(x, mesh, dim=-1, axis="model"):
        gathers.append(tuple(x.shape))
        return real(x, mesh, dim=dim, axis=axis)

    collectives.model_all_gather = counted
    try:
        state = train_state(model, opt, mesh)
    finally:
        collectives.model_all_gather = real
    return {"gathers": len(gathers),
            "state": None if state is None else _shapes(state)}


def _shapes(state):
    from repro_torch.models import bridge
    return {k: {n: a.shape for n, a in bridge.from_jax_tree(tree).items()}
            for k, tree in (("params", state["params"]),
                            ("mu", state["opt"].mu), ("nu", state["opt"].nu))}


def _child(job_path, rank, world, init_file):
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        fn = {"train": _job_train, "ce": _job_ce, "ops": _job_ops,
              "save": _job_save}[job["kind"]]
        out = fn(rank, world, **job["args"])
        dist.barrier()           # no rank tears gloo down under another
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
# The oracles, in this process.
# --------------------------------------------------------------------------
ROWS, COLS = 3, 4                  # test_torch_mrope.py's patch grid


def grid_positions(b: int, s: int, rows: int = ROWS, cols: int = COLS):
    """(3, B, S) int32 (``test_torch_mrope.py``'s): a rows x cols patch
    grid (t = 0, h = row, w = col), then text on all three streams from
    the grid's largest position + 1."""
    sp = rows * cols
    i = np.arange(sp)
    grid = np.stack([np.zeros(sp), i // cols, i % cols])
    text = max(rows, cols) + np.arange(s - sp)
    pos = np.concatenate([grid, np.broadcast_to(text, (3, s - sp))], axis=1)
    return np.ascontiguousarray(
        np.broadcast_to(pos[:, None], (3, b, s)).astype(np.int32))


def _batches(arch, n):
    from repro_torch import configs
    cfg = configs.smoke_config(arch)
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
        if arch == QWEN:                  # test_torch_mrope.py's batch
            b["patches"] = np.random.default_rng(20 + i).standard_normal(
                (B, ROWS * COLS, cfg.d_model)).astype(np.float32)
            b["positions"] = grid_positions(B, S)
        out.append(b)
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    import jax
    from repro import configs as jconfigs
    from repro.models import transformer as jtf
    jcfg = jconfigs.smoke_config(arch)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, params, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, accum):
    """JAX's meshless step at the global batch: (metrics, final params)."""
    import jax
    import jax.numpy as jnp
    from repro.core.mixed_precision import LossScale
    from repro.optim import adamw as jadamw
    from repro.train.train_step import TrainConfig, build_train_step
    jcfg, params, _ = _jax_params(arch)
    jcfg = dataclasses.replace(jcfg, attn_backend="interpret")
    step = jax.jit(build_train_step(jcfg, TrainConfig(
        policy="full", accum=accum, opt=jadamw.AdamWConfig(**OPT))))
    opt, ls, metrics = jadamw.init(params), LossScale.noop(), []
    for b in _batches(arch, STEPS):
        params, opt, ls, m = step(params, opt, ls,
                                  {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _port_run(arch, accum):
    """The port's meshless step at the global batch, in this process:
    (final params as a JAX tree, the first step's gradients)."""
    from repro_torch.optim import adamw
    real = adamw.update
    try:
        model, _, _, _, grads1 = _train(arch, _jax_params(arch)[2], accum,
                                        _batches(arch, STEPS), None)
    finally:
        adamw.update = real
    from repro_torch.models import bridge
    return bridge.export_params(model), {n: g.numpy()
                                         for n, g in grads1.items()}


def _leaves(tree):
    import jax
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _block(x, spec, shape, rank):
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh, coords
    mesh = Mesh(data=shape[0], model=shape[1])
    return shd.shard_leaf(x, spec, mesh, coords(mesh, rank))


def _replicated(spec) -> bool:
    return all(e is None for e in spec)


def _check_tp(outs, arch, accum, shape, nan_step):
    from repro_torch.models import bridge
    want, want_params = _jax_run(arch, accum)
    alone, grads_alone = _port_run(arch, accum)
    for out in outs:
        assert out["count"] == STEPS
        for m, jm in zip(out["metrics"], want):
            assert m["grads_finite"]
            assert m["lr"] == pytest.approx(jm["lr"], rel=1e-6)
            assert m["loss"] == pytest.approx(jm["loss"], rel=1e-5)
            assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-5)
        # every rank's metrics are the global ones, bit for bit
        assert out["metrics"] == outs[0]["metrics"]
    # the global parameters, gathered on rank 0 only
    assert all(out["global"] is None for out in outs[1:])
    got, ref, own = (_leaves(outs[0]["global"]), _leaves(want_params),
                     _leaves(alone))
    assert got.keys() == ref.keys()
    top = max(np.abs(v).max() for v in ref.values())
    for k, w in ref.items():
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - own[k]).max() <= 1e-5 * top, k
        assert np.abs(got[k] - w).max() <= 1e-4 * top, k
    specs = outs[0]["placement"]
    assert specs is not None and any(not _replicated(s)
                                      for s in specs.values())
    whole = bridge.from_jax_tree(alone)
    for r, out in enumerate(outs):
        assert out["placement"] == specs
        for n, g in out["grads1"].items():
            ref_g = _block(grads_alone[n], specs[n], shape, r)
            assert g.shape == ref_g.shape, n
            assert np.abs(g - ref_g).max() <= \
                1e-5 * np.abs(grads_alone[n]).max(), n
            assert np.abs(out["local"][n] - _block(whole[n], specs[n], shape,
                                                   r)).max() <= 1e-5 * top, n
            if _replicated(specs[n]):      # whole on every rank, bit-equal
                np.testing.assert_array_equal(g, outs[0]["grads1"][n])
                np.testing.assert_array_equal(out["local"][n],
                                              outs[0]["local"][n])
    if nan_step:
        for out in outs:                   # a NaN on rank 1 only: all skip
            assert out["nan"] == {"grads_finite": False, "count": STEPS,
                                  "unchanged": True}


# --------------------------------------------------------------------------
# The tests.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)],
                         ids=["heads_1x2", "seq_1x4", "dp_tp_2x2"])
def test_tp_step_matches_jax_meshless(tmp_path, shape, accum):
    from repro_torch import configs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer
    cfg = configs.smoke_config(ARCH)
    mode = "heads" if cfg.n_kv % shape[1] == 0 else "seq"
    specs = transformer.param_placement(cfg, Mesh(data=shape[0],
                                                  model=shape[1]))
    # sequence mode replicates the attention; heads mode splits it
    assert _replicated(specs["blocks.0.attn.wq"]) == (mode == "seq")
    outs = _spawn(tmp_path, "train", shape[0] * shape[1], arch=ARCH,
                  tree=_jax_params(ARCH)[2], accum=accum,
                  batches=_batches(ARCH, STEPS + 1), shape=shape,
                  nan_step=accum == 1)
    _check_tp(outs, ARCH, accum, shape, nan_step=accum == 1)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)],
                         ids=["dp_2x1", "tp_1x2", "dp_tp_2x2"])
def test_save_gathers_on_rank_zeros_model_group_only(tmp_path, shape):
    # the global state lands on rank 0 alone; only rank 0's model group
    # (data coordinate 0) gathers, one gather a sharded leaf of the
    # parameters, mu and nu; every other rank copies nothing
    from repro_torch import configs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import init_state, train_state
    from repro_torch.models import transformer
    cfg = configs.smoke_config(ARCH)
    mesh = Mesh(data=shape[0], model=shape[1])
    specs = transformer.param_placement(cfg, mesh)
    sharded = 0 if specs is None else sum(
        not _replicated(s) for s in specs.values())
    outs = _spawn(tmp_path, "save", shape[0] * shape[1], arch=ARCH,
                  shape=shape)
    assert outs[0]["state"] == _shapes(train_state(*init_state(cfg, 0,
                                                                "cpu")))
    assert all(out["state"] is None for out in outs[1:])
    assert [out["gathers"] for out in outs] == [
        3 * sharded if r < shape[1] else 0 for r in range(len(outs))]


def test_qwen2_vl_tied_head_on_two_ranks(tmp_path):
    from repro_torch import configs
    assert configs.smoke_config(QWEN).tie_embeddings
    outs = _spawn(tmp_path, "train", 2, arch=QWEN,
                  tree=_jax_params(QWEN)[2], accum=2,
                  batches=_batches(QWEN, STEPS + 1), shape=(1, 2),
                  nan_step=False)
    assert "lm_head" not in outs[0]["placement"]
    assert not _replicated(outs[0]["placement"]["embed"])
    _check_tp(outs, QWEN, 2, (1, 2), nan_step=False)


@pytest.mark.parametrize("world", [2, 4])
def test_vocab_parallel_ce(tmp_path, world):
    from repro_torch.models import transformer
    cfg = _ce_cfg()
    assert cfg.padded_vocab == 256 and cfg.vocab == CE_VOCAB
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 7, cfg.padded_vocab)) * 3).astype(
        np.float32)
    labels = rng.integers(0, CE_VOCAB, (2, 7)).astype(np.int32)
    labels[0, 0] = CE_VOCAB - 1                  # the last live index
    upstream = rng.uniform(0.5, 1.5, (2, 7)).astype(np.float32)
    outs = _spawn(tmp_path, "ce", world, logits=logits, labels=labels,
                  upstream=upstream)
    whole = torch.from_numpy(logits).requires_grad_()
    nll = transformer._ce_terms(transformer._mask_padded_vocab(whole, cfg),
                                torch.from_numpy(labels))
    (nll * torch.from_numpy(upstream)).sum().backward()
    v_l = cfg.padded_vocab // world
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["nll"], outs[0]["nll"])
        np.testing.assert_allclose(out["nll"], nll.detach().numpy(),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(
            out["grad"], whole.grad.numpy()[..., r * v_l:(r + 1) * v_l],
            rtol=0, atol=1e-6)
    # the dead tail (in the last block) takes no gradient
    assert not outs[-1]["grad"][..., CE_VOCAB - (world - 1) * v_l:].any()
    # loss_fn(mesh=), plain and chunked, against the meshless loss_fn
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(data=1, model=world)
    specs = transformer.param_placement(cfg, mesh)
    for chunk in (0, CE_CHUNK):
        model = transformer.init_params(cfg, 3, device="cpu").requires_grad_()
        loss, _ = transformer.loss_fn(model, cfg, _torch_batch(_ce_batch()),
                                      ce_chunk=chunk)
        loss.backward()
        grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
        for r, out in enumerate(outs):
            got = out[f"loss_{chunk}"]
            assert got["loss"] == pytest.approx(float(loss.detach()), rel=1e-6)
            for n, g in got["grads"].items():
                assert np.abs(g - _block(grads[n], specs[n], (1, world),
                                         r)).max() \
                    <= 1e-5 * np.abs(grads[n]).max(), (chunk, n)


def test_copy_to_model_and_reduce_from_model(tmp_path):
    from repro_torch.distributed import collectives
    outs = _spawn(tmp_path, "ops", 2)
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        a, b = outs[0][name], outs[1][name]

        def rounded(x):
            return torch.from_numpy(x).to(dt).float().numpy()

        # reduce_from_model: the f32 sum of the partials, rounded to dt;
        # its backward passes each rank's own upstream gradient
        total = rounded(a["x"] + b["x"])
        for o in (a, b):
            np.testing.assert_array_equal(o["y"], total)
            np.testing.assert_array_equal(o["x_grad"], rounded(o["w"]))
        # copy_to_model: the identity; its backward sums the ranks'
        # upstream gradients (each rounded to dt first) in f32
        summed = rounded(rounded(a["w"]) + rounded(b["w"]))
        for o in (a, b):
            np.testing.assert_array_equal(o["z"], o["shared"])
            np.testing.assert_array_equal(o["shared_grad"], summed)
    x = torch.ones(3, requires_grad=True)    # without a model axis: x itself
    assert collectives.copy_to_model(x, None) is x
    assert collectives.reduce_from_model(x, None) is x


# --------------------------------------------------------------------------
# The CLI and its checkpoints.
# --------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(world, ckpt, *args):
    """``launch.train`` at ``world`` ranks under torchrun's environment
    (1 rank: no environment, as a plain run)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--smoke", "--policy", "full", "--batch", "4", "--seq",
           "16", "--log-every", "1", "--ckpt-every", "2", "--ckpt-dir",
           str(ckpt), *args]
    env = [{}] if world == 1 else [dict(
        RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
        MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        for port in [str(_free_port())] for r in range(world)]
    return _join([subprocess.Popen(cmd, env=_env(**e), text=True,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE) for e in env])


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


def test_cli_model_axis_and_resharding_checkpoints(tmp_path):
    from repro_torch.checkpointing.ckpt import (CheckpointManager,
                                                _flatten_with_paths)
    from repro_torch.launch.train import state_like
    from repro_torch import configs
    tp, one = tmp_path / "tp", tmp_path / "one"
    # (1, 2) and 1 rank, 2 steps each, a checkpoint at step 2
    out_tp = _ok(_cli(2, tp, "--steps", "2", "--fresh"))
    out_one = _ok(_cli(1, one, "--steps", "2", "--fresh"))
    assert "mesh: data=1 x model=2 (2 devices)" in out_tp
    whole = _ok(_cli(1, tmp_path / "whole", "--steps", "4", "--fresh"))
    alone = _losses(whole)
    assert sorted(alone) == [0, 1, 2, 3]
    for step, loss in {**_losses(out_tp), **_losses(out_one)}.items():
        assert abs(loss - alone[step]) <= 1.5e-4, (step, loss)
    # the (1, 2) checkpoint holds the global arrays: a 1-rank save's tree
    m_tp, m_one = _manifest(tp), _manifest(one)
    assert m_tp["leaves"] == m_one["leaves"]
    assert m_tp["fingerprint"] == m_one["fingerprint"]
    cfg = configs.smoke_config(ARCH)
    a, _ = CheckpointManager(str(tp)).restore(2, state_like(cfg),
                                              config=cfg.arch_id)
    b, _ = CheckpointManager(str(one)).restore(2, state_like(cfg),
                                               config=cfg.arch_id)
    la, lb = _flatten_with_paths(a), _flatten_with_paths(b)
    top = max(np.abs(v).max() for k, v in lb.items() if "params" in k)
    for k, v in lb.items():
        assert la[k].shape == v.shape and la[k].dtype == v.dtype, k
        # the parameters as the DP test holds them to JAX's (AdamW divides
        # a near-zero gradient by its own scale); the moments leaf by leaf
        bound = 1e-4 * top if k.startswith("params") \
            else 1e-5 * np.abs(v).max()
        assert np.abs(la[k] - v).max() <= bound, k
    # (1, 2)'s checkpoint resumes at 1 rank, (2, 1) and (1, 4); the
    # 1-rank checkpoint at (1, 2): each continues the uninterrupted run
    resumes = [(1, tp, ()), (2, tp, ("--max-model", "1")),
               (4, tp, ()), (2, one, ())]
    banners = ["data=1 x model=1", "data=2 x model=1", "data=1 x model=4",
               "data=1 x model=2"]
    for i, ((world, src, extra), banner) in enumerate(zip(resumes,
                                                          banners)):
        dst = tmp_path / f"resume{i}"
        shutil.copytree(src, dst)
        out = _ok(_cli(world, dst, "--steps", "4", *extra))
        assert f"mesh: {banner}" in out
        assert "resumed from step 2 (data batch 2)" in out, out
        got = _losses(out)
        assert sorted(got) == [2, 3]
        for step, loss in got.items():
            assert abs(loss - alone[step]) <= 1.5e-4, (i, step, loss)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "whisper-base"])
def test_cli_refuses_unsharded_archs_on_a_model_axis(tmp_path, arch):
    outs = _cli(2, tmp_path / "ck", "--arch", arch, "--steps", "1",
                "--fresh")
    assert [rc for rc, _, _ in outs] == [2, 2]
    err = outs[0][2]
    if "minicpm" in arch:
        assert "mesh: data=1 x model=2" in err and "--max-model 1" in err
        assert "MLA" in err
    else:                 # refused on any mesh: the stream has no frames
        assert "frames" in err


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
