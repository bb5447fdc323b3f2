"""The SSM mixers over a mesh's model axis: mamba2-130m (pure SSD) and
hymba-1.5b (attention and SSM heads in parallel), served and trained on
(data, model) meshes, against the JAX package; and lockstep serving,
unsharded on any mesh.

Ranks are gloo subprocesses running this file (``tests/tp_ranks.py``),
joined with a timeout; the reference's numbers come from ONE more
subprocess (``_oracle``) with 4 emulated devices, into an ``.npz``.
Smoke configs (mamba2: 2 SSD layers, 4 heads of 16, N 16; hymba: 2
layers, 4 / 2 attention heads, window 16, global layer 0, 4 SSM heads),
weights from JAX's ``init_params(PRNGKey(0))`` carried across with
``bridge.load_jax_params(mesh=)``, inputs from numpy seeds, policy
``full``.  hymba is in heads mode on (1, 2) and in sequence mode on
(1, 4) (its 2 KV heads do not split 4 ways):

  * ``forward``'s logits on (1, 2) and (1, 4) against JAX's meshless
    ``forward`` and the reference's ``forward(mesh=)``;
  * the train step, 3 AdamW steps on (1, 2), (1, 4) and (2, 2), against
    JAX's meshless ``build_train_step`` at the global batch (4 x 32): the
    losses, grad norms and final parameters; every replicated leaf (each
    ``ssm`` leaf, the norms, hymba's mix norms, the attention in sequence
    mode) bit-equal across ranks, its first-step gradient and its value
    after the steps alike;
  * ``make_serve_steps``: the prefill of 2 x 24 prompts into a 32-slot
    cache and 8 greedy decode steps on (1, 2) and (1, 4) against the
    port's meshless steps and JAX's greedy lockstep (``serve_step``,
    ``kvq_backend="ref"``): tokens exact; hymba's global layer decodes by
    length over a sequence-split cache on (1, 4), its windowed layer by
    the band's bias (positions 24-31 pass the 16-slot window);
  * the placement (every ``ssm`` leaf whole), the two-tier cache's
    refusal of a model axis, the remat plan of ``make_train_step(mesh=)``
    against the reference's, the SSD op's forward and backward
    bit-repeatable;
  * the CLIs under torchrun's environment (2 ranks, ``--device cpu
    --smoke --policy full``): ``launch/train.py --arch hymba-1.5b``
    prints the (1, 2) banner and its losses equal a 1-rank run's to the
    printed 4 decimals; its checkpoint resumes at 1 rank and at (1, 4);
    ``launch/serve.py --arch mamba2-130m`` (lockstep) prints rank 0's
    stream, equal to a 1-rank run's, and rank 1 prints nothing and never
    reaches the lockstep.

Tolerances (``test_torch_moe_tp.py``'s where they hold), the largest
value measured on this tree beside each.  Logits: 1e-6 of the largest
|logit| against the port's meshless forward (mamba2 0, hymba 7.5e-7),
and 1e-5 against JAX's meshless forward and the reference's mesh (1.8e-6
/ 2.2e-6): the chunked SSD rounds its recurrence unlike JAX's, and the
meshless port is itself 1.8e-6 / 2.1e-6 from JAX.  The train step:
losses 1e-5 relative (2.3e-6), grad norms 1e-5 relative (7.8e-7) but
hymba's after its first step 1e-4 (4.6e-5), final parameters 1e-4 of
the largest parameter (mamba2 6.2e-6 over every entry; hymba over the
entries whose step-1 gradient is at least 1e-3 of its leaf's largest:
the meshless port reads 7.7e-6 there).  hymba's smoke gradients carry
entries at the f32 noise floor (step 1's norm agrees to 3.3e-6), which
AdamW moves by a fraction of lr that differs from run to run: the
meshless port reads 3.5e-5 on the later grad norms and 1.8e-4 on every
entry of the parameters against JAX, so those two gates are not the
mesh's to meet.  The serve steps'
logits 1e-5 of the largest against the meshless steps (7.3e-7) and
JAX's lockstep (1.0e-6).  The CLI's losses to the printed 4 decimals
(1.5e-4).
"""
from __future__ import annotations

import functools
import pickle
import re
import shutil
import sys

import numpy as np
import pytest
import torch

import tp_ranks

THIS = tp_ranks.pathlib.Path(__file__).resolve()
M2, HY = "mamba2-130m", "hymba-1.5b"
ARCHS = (M2, HY)
STEPS, B, S = 3, 4, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
FWD = (2, 32)                  # forward's tokens
PROMPT, GEN = (2, 24), 8       # serve steps: prompts, decode steps
S_MAX = PROMPT[1] + GEN
SHAPES = [(1, 2), (1, 4), (2, 2)]


def _cfg(arch, jax=False):
    if jax:
        from repro import configs
    else:
        from repro_torch import configs
    return configs.smoke_config(arch)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape) \
        .astype(np.int32)


def _batches():
    out = []
    for i in range(STEPS):
        toks = _tokens((B, S + 1), 10 + i)
        out.append({"tokens": toks[:, :-1].copy(),
                    "labels": toks[:, 1:].copy()})
    return out


# --------------------------------------------------------------------------
# The reference's numbers, in one subprocess with 4 emulated devices.
# --------------------------------------------------------------------------
def _oracle(out_path):
    import jax
    import jax.numpy as jnp
    from repro.core.mixed_precision import LossScale
    from repro.launch.mesh import make_mesh
    from repro.models import transformer as jtf
    from repro.optim import adamw as jadamw
    from repro.train import serve_step as jss
    from repro.train.train_step import TrainConfig, build_train_step
    out = {}
    for arch in ARCHS:
        jcfg = _cfg(arch, jax=True)
        params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(_tokens(FWD, 1))}
        out[f"fwd/{arch}"] = jtf.forward(params, jcfg, batch)[0]
        for n in (2, 4):
            mesh = make_mesh((1, n), ("data", "model"))
            out[f"mesh{n}/{arch}"] = jax.jit(
                lambda p, b, m=mesh, c=jcfg: jtf.forward(p, c, b, mesh=m)[0]
            )(params, batch)
        prefill = jax.jit(jss.build_prefill_step(
            jcfg, policy_name="full", s_max=S_MAX))
        decode = jax.jit(jss.build_decode_step(jcfg, policy_name="full"))
        logits, cache = prefill(params, {"tokens": jnp.asarray(
            _tokens(PROMPT, 2))})
        seq, fed = [logits], []
        for _ in range(GEN):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            fed.append(tok)
            logits, cache = decode(params, cache, tok)
            seq.append(logits)
        out[f"serve/{arch}/logits"] = jnp.stack(seq)
        out[f"serve/{arch}/tokens"] = jnp.stack(fed, 1)
        step = jax.jit(build_train_step(jcfg, TrainConfig(
            policy="full", opt=jadamw.AdamWConfig(**OPT))))
        opt, ls = jadamw.init(params), LossScale.noop()
        for i, b in enumerate(_batches()):
            params, opt, ls, m = step(params, opt, ls, {
                k: jnp.asarray(v) for k, v in b.items()})
            for k in ("loss", "grad_norm"):
                out[f"step/{arch}/{i}/{k}"] = m[k]
        for path, v in jax.tree_util.tree_leaves_with_path(params):
            out[f"final/{arch}/{jax.tree_util.keystr(path)}"] = v
        params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        b0 = {k: jnp.asarray(v) for k, v in _batches()[0].items()}
        grads = jax.grad(lambda p, c=jcfg: jtf.loss_fn(p, c, b0)[0])(params)
        for path, v in jax.tree_util.tree_leaves_with_path(grads):
            out[f"grad1/{arch}/{jax.tree_util.keystr(path)}"] = v
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


@functools.lru_cache(maxsize=None)
def _tmp():
    return tp_ranks.tmpdir("ssm_tp_")


@functools.lru_cache(maxsize=None)
def _jax_tree(arch):
    import jax
    from repro.models import transformer as jtf
    return jax.tree.map(np.asarray, jtf.init_params(
        _cfg(arch, jax=True), jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _started():
    """The oracle and every mesh's ranks, all started together."""
    oracle = _tmp() / "oracle.npz"
    trees = {a: _jax_tree(a) for a in ARCHS}
    return (oracle, tp_ranks.start_oracle(THIS, oracle),
            {shape: tp_ranks.start(THIS, _tmp(), "mesh",
                                   shape[0] * shape[1], shape=shape,
                                   trees=trees) for shape in SHAPES})


@functools.lru_cache(maxsize=None)
def _ref() -> dict:
    path, proc, _ = _started()
    (rc, _, err), = tp_ranks.join([proc])
    assert rc == 0, err[-3000:]
    with np.load(path) as z:
        return dict(z)


@functools.lru_cache(maxsize=None)
def _ranks(shape):
    return tp_ranks.results(_started()[2][shape])


# --------------------------------------------------------------------------
# The ranks (run in subprocesses: ``python test_torch_ssm_tp.py ...``).
# --------------------------------------------------------------------------
def _serve(model, cfg, mesh):
    """``make_serve_steps``' prefill and GEN greedy decode steps -> (the
    logits (GEN + 1, B, V), the fed tokens (B, GEN))."""
    from repro_torch.train.serve_step import make_serve_steps
    prompts = torch.from_numpy(_tokens(PROMPT, 2))
    prefill, _ = make_serve_steps(cfg, mesh, {"tokens": prompts},
                                  kind="prefill", policy_name="full",
                                  s_max=S_MAX)
    decode, _ = make_serve_steps(cfg, mesh, {"tokens_t": prompts[:, 0]},
                                 kind="decode", policy_name="full")
    with torch.no_grad():
        logits, cache = prefill(model, {"tokens": prompts})
        seq, fed = [logits], []
        for _ in range(GEN):
            tok = logits.argmax(-1).to(torch.int32)
            fed.append(tok)
            logits, cache = decode(model, cache, tok)
            seq.append(logits)
    return torch.stack(seq).numpy(), torch.stack(fed, 1).numpy()


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
    return seen, real


def _train(cfg, tree, mesh, batches):
    from repro_torch.models import bridge
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (TrainConfig, init_loss_scale,
                                              make_train_step)
    model = bridge.load_jax_params(cfg, tree, device="cpu",
                                   mesh=mesh).requires_grad_()
    opt = adamw.init(dict(model.named_parameters()))
    tc = TrainConfig(policy="full", opt=adamw.AdamWConfig(**OPT))
    seen, real = _keep_first_grads()
    step, tc = make_train_step(cfg, tc, {"tokens": torch.empty(
        (B, S), dtype=torch.int32, device="meta")}, mesh=mesh)
    ls = init_loss_scale(tc, "cpu")
    metrics = []
    try:
        for b in batches:
            model, opt, ls, m = step(model, opt, ls, {
                k: torch.from_numpy(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        adamw.update = real
    return {"metrics": metrics, "placement": step.placement,
            "grads1": {n: g.numpy() for n, g in seen[0].items()},
            "local": {n: p.detach().numpy().copy()
                      for n, p in model.named_parameters()},
            "global": bridge.export_params(model, mesh=mesh)}


def _job_mesh(rank, world, shape, trees):
    from repro_torch.core.mixed_precision import Policy
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import bridge, transformer
    mesh = Mesh(data=shape[0], model=shape[1])
    out = {}
    for arch, tree in trees.items():
        cfg = _cfg(arch)
        o = out[arch] = {}
        if shape[0] == 1:
            model = bridge.load_jax_params(cfg, tree, device="cpu",
                                           mesh=mesh)
            with torch.no_grad():
                o["logits"] = transformer.forward(
                    model, cfg, {"tokens": torch.from_numpy(_tokens(FWD, 1))},
                    policy=Policy.full(), mesh=mesh)[0].numpy()
            o["serve"] = _serve(model, cfg, mesh)
        o["train"] = _train(cfg, tree, mesh, _batches())
    return out


# --------------------------------------------------------------------------
# Forward and serving.
# --------------------------------------------------------------------------
def _replicated(spec) -> bool:
    return all(e is None for e in spec)


@functools.lru_cache(maxsize=None)
def _meshless_logits(arch):
    from repro_torch.core.mixed_precision import Policy
    from repro_torch.models import bridge, transformer
    cfg = _cfg(arch)
    model = bridge.load_jax_params(cfg, _jax_tree(arch), device="cpu")
    with torch.no_grad():
        return transformer.forward(
            model, cfg, {"tokens": torch.from_numpy(_tokens(FWD, 1))},
            policy=Policy.full())[0].numpy()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, world):
    ref = _ref()
    want = ref[f"fwd/{arch}"]
    top = np.abs(want).max()
    alone = _meshless_logits(arch)
    # the chunked SSD rounds its recurrence unlike JAX's: the meshless
    # port's own distance, which the mesh adds nothing to beyond 1e-6
    assert np.abs(alone - want).max() <= 1e-5 * top
    ranks = _ranks((1, world))
    for out in ranks:
        got = out[arch]["logits"]
        np.testing.assert_array_equal(got, ranks[0][arch]["logits"])
        assert np.abs(got - alone).max() <= 1e-6 * top
        assert np.abs(got - want).max() <= 1e-5 * top
        assert np.abs(got - ref[f"mesh{world}/{arch}"]).max() <= 1e-5 * top


@functools.lru_cache(maxsize=None)
def _meshless_serve(arch):
    from repro_torch.models import bridge
    from repro_torch.train import serve_step
    cfg = _cfg(arch)
    model = bridge.load_jax_params(cfg, _jax_tree(arch), device="cpu")
    prefill = serve_step.build_prefill_step(cfg, policy_name="full",
                                            s_max=S_MAX)
    decode = serve_step.build_decode_step(cfg, policy_name="full")
    prompts = torch.from_numpy(_tokens(PROMPT, 2))
    with torch.no_grad():
        logits, cache = prefill(model, {"tokens": prompts})
        seq, fed = [logits], []
        for _ in range(GEN):
            tok = logits.argmax(-1).to(torch.int32)
            fed.append(tok)
            logits, cache = decode(model, cache, tok)
            seq.append(logits)
    return torch.stack(seq).numpy(), torch.stack(fed, 1).numpy()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_jax(arch, world):
    ref = _ref()
    want, want_tok = ref[f"serve/{arch}/logits"], ref[f"serve/{arch}/tokens"]
    alone, alone_tok = _meshless_serve(arch)
    np.testing.assert_array_equal(alone_tok, want_tok)
    top = np.abs(want).max()
    assert np.abs(alone - want).max() <= 1e-5 * top
    for out in _ranks((1, world)):
        logits, tokens = out[arch]["serve"]
        np.testing.assert_array_equal(tokens, want_tok)
        assert np.abs(logits - alone).max() <= 1e-5 * top
        assert np.abs(logits - want).max() <= 1e-5 * top


def test_hymba_modes_on_each_mesh():
    """The serve steps' cache layouts: heads on (1, 2), the sequence on
    (1, 4); the conv tail and the SSM state whole on every rank."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer
    cfg = _cfg(HY)
    for n, mode in ((2, "heads"), (4, "seq")):
        mesh = Mesh(data=1, model=n)
        assert shd.serve_kv_shard(mesh, cfg.n_kv, S_MAX) == mode
        cache = transformer.init_cache(cfg, 2, S_MAX, device="meta",
                                       mesh=mesh)
        whole = transformer.init_cache(cfg, 2, S_MAX, device="meta")
        for k in ("conv", "ssm"):
            assert cache[k].shape == whole[k].shape
        ax = 2 if mode == "heads" else 3
        assert cache["k"].shape[ax] * n == whole["k"].shape[ax]
    m2 = transformer.init_cache(_cfg(M2), 2, S_MAX, device="meta",
                                mesh=Mesh(data=1, model=4))
    assert sorted(m2) == ["conv", "pos", "ssm"]


# --------------------------------------------------------------------------
# The train step.
# --------------------------------------------------------------------------
def _tree_named(prefix: str) -> dict:
    return tp_ranks.tree_named(_ref(), prefix)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "1x4", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_meshless(arch, shape):
    from repro_torch.models import bridge
    ref = _ref()
    outs = [o[arch]["train"] for o in _ranks(shape)]
    for out in outs:
        for i, m in enumerate(out["metrics"]):
            assert m["grads_finite"]
            assert m["loss"] == pytest.approx(
                float(ref[f"step/{arch}/{i}/loss"]), rel=1e-5), i
            # hymba after AdamW has moved its noise-floor entries: 1e-4
            rel = 1e-5 if i == 0 or arch == M2 else 1e-4
            assert m["grad_norm"] == pytest.approx(
                float(ref[f"step/{arch}/{i}/grad_norm"]), rel=rel), i
        assert out["metrics"] == outs[0]["metrics"]
    assert all(out["global"] is None for out in outs[1:])
    got = bridge.from_jax_tree(outs[0]["global"])
    want = _tree_named(f"final/{arch}/")
    grad1 = _tree_named(f"grad1/{arch}/")
    assert got.keys() == want.keys()
    top = max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        diff = np.abs(got[k] - w)
        if arch == HY:       # the entries above the step-1 gradient floor
            g = np.abs(grad1[k])
            diff = diff[g >= 1e-3 * g.max()]
        assert diff.max(initial=0.0) <= 1e-4 * top, k
    specs = outs[0]["placement"]
    ssm = [n for n in specs if ".ssm." in n]
    assert ssm and all(specs[n] == () for n in ssm)
    assert specs["blocks.0.ln1"] == ()
    if arch == HY:
        assert specs["blocks.1.mix_norm_ssm"] == ()
        seq = shape[1] == 4                 # 2 KV heads split 2 ways only
        assert specs["blocks.1.attn.wk"] == (() if seq else (None, "model"))
        assert specs["blocks.1.ffn.w_down"] == ("model", None)
    for out in outs:
        assert out["placement"] == specs
        for n, spec in specs.items():
            if _replicated(spec):          # whole on every rank, bit-equal
                np.testing.assert_array_equal(out["grads1"][n],
                                              outs[0]["grads1"][n])
                np.testing.assert_array_equal(out["local"][n],
                                              outs[0]["local"][n])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_plan_on_a_model_axis_equals_reference(arch):
    """The per-device profile of ``plan_profile(mesh=)`` (carry bytes and
    labels) is the reference's at full width on (1, 2) and (1, 4), and for
    mamba2 ``resolve_remat(mesh=)`` under a memory budget solves the
    reference's plan (hymba's global layers are flash-eligible in the
    port's planner only, ROADMAP section 3, so its residuals and plan
    differ by design)."""
    import jax
    import jax.numpy as jnp
    from repro.launch import mesh as jmesh
    from repro.train import train_step as jts
    from repro_torch import configs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train import train_step as ts
    from repro import configs as jconfigs
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    sds = {"tokens": torch.empty((8, 2048), dtype=torch.int32,
                                 device="meta")}
    jsds = {"tokens": jax.ShapeDtypeStruct((8, 2048), jnp.int32)}
    for n in (2, 4):
        mesh = Mesh(data=1, model=n)
        jm = jmesh.abstract_mesh((1, n), ("data", "model"))
        got = ts.plan_profile(cfg, ts.TrainConfig(), sds, mesh=mesh)
        want = jts.plan_profile(jcfg, jts.TrainConfig(), jsds, mesh=jm)
        assert got.act_bytes == want.act_bytes
        assert got.labels == want.labels
        if arch == HY:
            continue
        tc = ts.resolve_remat(cfg, ts.TrainConfig(mem_budget_mb=2048), sds,
                              mesh=mesh)
        jtc = jts.resolve_remat(jcfg, jts.TrainConfig(mem_budget_mb=2048),
                                jsds, mesh=jm)
        assert tc.remat.plan is not None
        assert tc.remat.plan.boundaries == jtc.remat.plan.boundaries
        assert tc.remat.plan.policy == jtc.remat.plan.policy


# --------------------------------------------------------------------------
# Pieces that need no ranks.
# --------------------------------------------------------------------------
def test_two_tier_cache_refuses_a_model_axis():
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer
    cfg = _cfg(HY)
    transformer.init_cache_two_tier(cfg, 2, 64, device="cpu",
                                    mesh=Mesh(data=2, model=1))
    with pytest.raises(NotImplementedError, match="two-tier"):
        transformer.init_cache_two_tier(cfg, 2, 64, device="cpu",
                                        mesh=Mesh(data=1, model=2))


def test_ssd_forward_and_backward_are_bit_repeatable():
    """Every rank runs the SSM whole, so its leaves' gradients are the same
    bits on each only if the op is deterministic: the chunk, the
    inter-chunk recurrence and their backward, run twice."""
    from repro_torch.kernels.ssd import ops
    rng = np.random.default_rng(5)
    b, L, h, p, n = 2, 96, 4, 16, 16
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((b, L, h, p), (b, L, h), (h,), (b, L, n), (b, L, n),
                      (h,))]
    args[1] = torch.nn.functional.softplus(args[1])
    args[2] = -torch.exp(args[2])
    runs = []
    for _ in range(2):
        xs = [a.clone().requires_grad_() for a in args]
        y, state = ops.ssd(*xs, chunk=32, return_state=True)
        (y.square().sum() + state.sum()).backward()
        runs.append([y.detach(), state.detach()] + [x.grad for x in xs])
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


# --------------------------------------------------------------------------
# The CLIs under torchrun's environment.
# --------------------------------------------------------------------------
def _train_cli(world, ckpt, *args):
    return tp_ranks.launch(world, [
        sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
        "--smoke", "--arch", HY, "--policy", "full", "--batch", "4",
        "--seq", "32", "--log-every", "1", "--ckpt-every", "2",
        "--ckpt-dir", str(ckpt), *args])


def _losses(stdout):
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"step\s+(\d+) loss (\S+)", stdout)}


def _ok(outs):
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return outs[0][1]


def test_cli_trains_hymba_and_resumes_on_another_mesh(tmp_path):
    tp = tmp_path / "tp"
    out_tp = _ok(_train_cli(2, tp, "--steps", "2", "--fresh"))
    assert "mesh: data=1 x model=2 (2 devices)" in out_tp
    alone = _losses(_ok(_train_cli(1, tmp_path / "whole", "--steps", "4",
                                   "--fresh")))
    assert sorted(alone) == [0, 1, 2, 3]
    got = _losses(out_tp)
    assert sorted(got) == [0, 1]
    for step, loss in got.items():
        assert abs(loss - alone[step]) <= 1.5e-4, (step, loss)
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


def test_cli_lockstep_serves_unsharded_on_two_ranks(tmp_path):
    def cli(world, out):
        return tp_ranks.launch(world, [
            sys.executable, str(THIS), "cli", str(out), "--device", "cpu",
            "--smoke", "--arch", M2, "--policy", "full", "--gen", "8"])

    two = cli(2, tmp_path / "two")
    out = _ok(two)
    assert "mesh: data=1 x model=2 (2 devices)" in out
    assert "lockstep: unsharded on rank 0's device" in out
    assert two[1][1] == ""                   # rank 1 prints nothing
    assert not (tmp_path / "two.1").exists()  # and never serves
    _ok(cli(1, tmp_path / "one"))
    with open(tmp_path / "two.0", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "one.0", "rb") as f:
        want = pickle.load(f)
    assert got.shape == want.shape == (4, 8)
    np.testing.assert_array_equal(got, want)


if __name__ == "__main__":
    if sys.argv[1] == "oracle":
        _oracle(sys.argv[2])
    elif sys.argv[1] == "cli":
        raise SystemExit(tp_ranks.lockstep_child(sys.argv[2], sys.argv[3:]))
    else:
        tp_ranks.child({"mesh": _job_mesh}, sys.argv[1], int(sys.argv[2]),
                       int(sys.argv[3]), sys.argv[4])
