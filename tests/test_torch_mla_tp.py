"""MLA (minicpm3-4b's latent attention) over a mesh's model axis, trained
and served on (data, model) meshes, against the JAX package.

Ranks are gloo subprocesses running this file (``tests/tp_ranks.py``),
joined with a timeout; the reference's numbers come from ONE more
subprocess (``_oracle``) with 4 emulated devices, into an ``.npz``.
Smoke minicpm3 (2 layers, 4 heads, q_lora 32, kv_lora 16, nope / rope /
v 8), weights from JAX's ``init_params(PRNGKey(0))`` carried across with
``bridge.load_jax_params(mesh=)``, inputs from numpy seeds, policy
``full``.  The 4 heads split 2 and 4 ways: ``q_b`` / ``kv_b`` by head,
``wo`` by its rows, the rest whole on every rank:

  * ``forward``'s logits on (1, 2) and (1, 4) against JAX's meshless
    ``forward`` and the reference's ``forward(mesh=)``;
  * the train step, 3 AdamW steps on (1, 2), (1, 4) and (2, 2), against
    JAX's meshless ``build_train_step`` at the global batch (4 x 32): the
    losses, grad norms and final parameters; every replicated leaf
    (``q_a``, ``kv_a``, both latent norms, the layer norms) bit-equal
    across ranks, its first-step gradient and its value after the steps
    alike;
  * ``make_serve_steps``: the prefill of 2 x 24 prompts into a 32-slot
    latent cache split by sequence (16 / 8 slots a rank) and 8 greedy
    decode steps on (1, 2) and (1, 4) against the port's meshless steps
    and JAX's greedy lockstep (``serve_step``): tokens exact, with the
    reference's bf16 latents, and with the decode steps started from the
    meshless prefill's cache in f32 latents;
  * the placement, the latent cache's, and a head count that does not
    divide the axis (the block whole on every rank);
  * ``launch/train.py --arch minicpm3-4b`` under torchrun's environment
    on 2 ranks (``--device cpu --smoke --policy full``): the (1, 2)
    banner, and losses equal to a 1-rank run's to the printed 4
    decimals.

Tolerances (``test_torch_ssm_tp.py``'s), the largest value measured on
this tree beside each.  Logits: 1e-5 of the largest |logit| against the
port's meshless forward (6.4e-7) and against JAX's meshless forward and
the reference's mesh (9.5e-7 / 9.5e-7; the meshless port is 1.0e-6 from
JAX).  The train step: losses 1e-5 relative (1.6e-7), grad norms 1e-5
relative (2.6e-7), final parameters 1e-4 of the largest parameter
(7.1e-6).  The serve steps' logits with bf16 latents 1e-4 of the largest
against the meshless steps and JAX's lockstep (a last-bit difference of
an f32 latent can flip its bf16 rounding: 3.0e-5 / 3.0e-5), from the
f32 latents 1e-5 against the meshless steps (6.8e-7; JAX keeps bf16
latents, so they are not held against it).  The CLI's losses to the
printed 4 decimals.
"""
from __future__ import annotations

import functools
import re
import sys

import numpy as np
import pytest
import torch

import tp_ranks

THIS = tp_ranks.pathlib.Path(__file__).resolve()
ARCH = "minicpm3-4b"
STEPS, B, S = 3, 4, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
FWD = (2, 32)                  # forward's tokens
PROMPT, GEN = (2, 24), 8       # serve steps: prompts, decode steps
S_MAX = PROMPT[1] + GEN
SHAPES = [(1, 2), (1, 4), (2, 2)]
LOGIT_TOL, TRAIN_TOL, PARAM_TOL = 1e-5, 1e-5, 1e-4
BF16_LATENT_TOL = 1e-4


def _cfg(jax=False):
    if jax:
        from repro import configs
    else:
        from repro_torch import configs
    return configs.smoke_config(ARCH)


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
    jcfg = _cfg(jax=True)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    batch = {"tokens": jnp.asarray(_tokens(FWD, 1))}
    out["fwd"] = jtf.forward(params, jcfg, batch)[0]
    for n in (2, 4):
        mesh = make_mesh((1, n), ("data", "model"))
        out[f"mesh{n}"] = jax.jit(
            lambda p, b, m=mesh: jtf.forward(p, jcfg, b, mesh=m)[0]
        )(params, batch)
    prefill = jax.jit(jss.build_prefill_step(jcfg, policy_name="full",
                                             s_max=S_MAX))
    decode = jax.jit(jss.build_decode_step(jcfg, policy_name="full"))
    logits, cache = prefill(params, {"tokens": jnp.asarray(
        _tokens(PROMPT, 2))})
    seq, fed = [logits], []
    for _ in range(GEN):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(tok)
        logits, cache = decode(params, cache, tok)
        seq.append(logits)
    out["serve/logits"] = jnp.stack(seq)
    out["serve/tokens"] = jnp.stack(fed, 1)
    step = jax.jit(build_train_step(jcfg, TrainConfig(
        policy="full", opt=jadamw.AdamWConfig(**OPT))))
    opt, ls = jadamw.init(params), LossScale.noop()
    for i, b in enumerate(_batches()):
        params, opt, ls, m = step(params, opt, ls, {
            k: jnp.asarray(v) for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            out[f"step/{i}/{k}"] = m[k]
    for path, v in jax.tree_util.tree_leaves_with_path(params):
        out[f"final/{jax.tree_util.keystr(path)}"] = v
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


@functools.lru_cache(maxsize=None)
def _tmp():
    return tp_ranks.tmpdir("mla_tp_")


@functools.lru_cache(maxsize=None)
def _jax_tree():
    import jax
    from repro.models import transformer as jtf
    return jax.tree.map(np.asarray, jtf.init_params(
        _cfg(jax=True), jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _started():
    """The oracle and every mesh's ranks, all started together."""
    oracle = _tmp() / "oracle.npz"
    return (oracle, tp_ranks.start_oracle(THIS, oracle),
            {shape: tp_ranks.start(THIS, _tmp(), "mesh",
                                   shape[0] * shape[1], shape=shape,
                                   tree=_jax_tree()) for shape in SHAPES})


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
# The ranks (run in subprocesses: ``python test_torch_mla_tp.py ...``).
# --------------------------------------------------------------------------
def _f32_block(cfg, cache, mesh):
    """This rank's block of a meshless decode cache (``cache_specs``),
    MLA's latents in f32."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import coords
    from repro_torch.models import transformer
    specs = None if mesh is None else transformer.cache_specs(cfg, cache,
                                                              mesh)
    out = {}
    for k, v in cache.items():
        if specs is not None and k != "pos":
            v = shd.shard_leaf(v, specs[k], mesh, coords(mesh))
        out[k] = v.float() if k in ("mla_lat", "mla_rope") else v
    return out


def _serve(model, cfg, mesh, f32_from=None):
    """The prefill and GEN greedy decode steps (``make_serve_steps`` with
    ``mesh``, the meshless step functions without) -> (the logits (GEN +
    1, B, V), the fed tokens (B, GEN), the prefill cache's latent
    shape).  ``f32_from`` (the meshless model): the decode steps start
    from this rank's block of the meshless prefill's cache, its latents
    in f32 (the decode steps then write f32 latents), so that neither
    run's bf16 rounding of its latents shows in the logits."""
    from repro_torch.train import serve_step
    prompts = torch.from_numpy(_tokens(PROMPT, 2))
    if mesh is None:
        prefill = serve_step.build_prefill_step(
            cfg, policy_name="full", s_max=S_MAX)
        decode = serve_step.build_decode_step(cfg, policy_name="full")
    else:
        prefill, _ = serve_step.make_serve_steps(
            cfg, mesh, {"tokens": prompts}, kind="prefill",
            policy_name="full", s_max=S_MAX)
        decode, _ = serve_step.make_serve_steps(
            cfg, mesh, {"tokens_t": prompts[:, 0]}, kind="decode",
            policy_name="full")
    with torch.no_grad():
        logits, cache = prefill(model, {"tokens": prompts})
        lat = tuple(cache["mla_lat"].shape)
        if f32_from is not None:
            whole = serve_step.build_prefill_step(
                cfg, policy_name="full", s_max=S_MAX)(
                f32_from, {"tokens": prompts})[1]
            cache = _f32_block(cfg, whole, mesh)
        seq, fed = [logits], []
        for _ in range(GEN):
            tok = logits.argmax(-1).to(torch.int32)
            fed.append(tok)
            logits, cache = decode(model, cache, tok)
            seq.append(logits)
    return torch.stack(seq).numpy(), torch.stack(fed, 1).numpy(), lat


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


def _train(cfg, tree, mesh):
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
        for b in _batches():
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


def _job_mesh(rank, world, shape, tree):
    from repro_torch.core.mixed_precision import Policy
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import bridge, transformer
    mesh = Mesh(data=shape[0], model=shape[1])
    cfg = _cfg()
    out = {}
    if shape[0] == 1:
        model = bridge.load_jax_params(cfg, tree, device="cpu", mesh=mesh)
        with torch.no_grad():
            out["logits"] = transformer.forward(
                model, cfg, {"tokens": torch.from_numpy(_tokens(FWD, 1))},
                policy=Policy.full(), mesh=mesh)[0].numpy()
        out["serve"] = _serve(model, cfg, mesh)
        out["serve_f32"] = _serve(model, cfg, mesh, f32_from=(
            bridge.load_jax_params(cfg, tree, device="cpu")))
    out["train"] = _train(cfg, tree, mesh)
    return out


# --------------------------------------------------------------------------
# Forward and serving.
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _meshless_model():
    from repro_torch.models import bridge
    return bridge.load_jax_params(_cfg(), _jax_tree(), device="cpu")


@pytest.mark.parametrize("world", [2, 4])
def test_forward_matches_jax(world):
    from repro_torch.core.mixed_precision import Policy
    from repro_torch.models import transformer
    ref = _ref()
    want = ref["fwd"]
    top = np.abs(want).max()
    with torch.no_grad():
        alone = transformer.forward(
            _meshless_model(), _cfg(),
            {"tokens": torch.from_numpy(_tokens(FWD, 1))},
            policy=Policy.full())[0].numpy()
    ranks = _ranks((1, world))
    for out in ranks:
        got = out["logits"]
        np.testing.assert_array_equal(got, ranks[0]["logits"])
        assert np.abs(got - alone).max() <= LOGIT_TOL * top
        assert np.abs(got - want).max() <= LOGIT_TOL * top
        assert np.abs(got - ref[f"mesh{world}"]).max() <= LOGIT_TOL * top


@pytest.mark.parametrize("latents", ["bf16", "f32"])
@pytest.mark.parametrize("world", [2, 4])
def test_serve_steps_match_jax(world, latents):
    ref = _ref()
    want, want_tok = ref["serve/logits"], ref["serve/tokens"]
    top = np.abs(want).max()
    alone, alone_tok, whole = _serve(
        _meshless_model(), _cfg(), None,
        f32_from=_meshless_model() if latents == "f32" else None)
    np.testing.assert_array_equal(alone_tok, want_tok)
    key = "serve" if latents == "bf16" else "serve_f32"
    tol = BF16_LATENT_TOL if latents == "bf16" else LOGIT_TOL
    for out in _ranks((1, world)):
        logits, tokens, lat = out[key]
        np.testing.assert_array_equal(tokens, want_tok)
        # the latent cache: this rank's block of the sequence
        assert lat[:2] + lat[3:] == whole[:2] + whole[3:]
        assert lat[2] * world == whole[2] == S_MAX
        assert np.abs(logits - alone).max() <= tol * top
        if latents == "bf16":           # the reference's latents are bf16
            assert np.abs(logits - want).max() <= tol * top


def test_placement_splits_heads_or_keeps_the_block_whole():
    """``q_b`` / ``kv_b`` split by head and ``wo`` by its rows where the
    4 heads divide the axis; everything else whole; on an axis of 3 the
    block stays whole (no head is cut).  The latent cache splits by
    sequence, and refuses slots that do not divide."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer
    cfg = _cfg()
    shapes = {n: tuple(p.shape) for n, p in transformer.init_params(
        cfg, device="meta").named_parameters()}
    for n in (2, 4):
        specs = transformer.param_shard_specs(cfg, shapes,
                                              Mesh(data=1, model=n))
        a = "blocks.1.attn"
        assert specs[f"{a}.q_b"] == (None, "model")
        assert specs[f"{a}.kv_b"] == (None, "model")
        assert specs[f"{a}.wo"] == ("model", None)
        for leaf in ("q_a", "q_a_norm", "kv_a", "kv_a_norm"):
            assert specs[f"{a}.{leaf}"] == (), leaf
        cache = transformer.init_cache(cfg, 2, S_MAX, device="meta",
                                       mesh=Mesh(data=1, model=n))
        assert cache["mla_lat"].shape[2] == S_MAX // n
        assert cache["mla_rope"].shape[2] == S_MAX // n
    specs = transformer.param_shard_specs(cfg, shapes, Mesh(data=1, model=3))
    assert all(specs[f"blocks.0.attn.{leaf}"] == ()
               for leaf in ("q_b", "kv_b", "wo"))
    transformer.check_mesh(cfg, Mesh(data=1, model=2))   # no refusal
    with pytest.raises(ValueError, match="latent"):
        transformer.init_cache(cfg, 2, 30, device="meta",
                               mesh=Mesh(data=1, model=4))


# --------------------------------------------------------------------------
# The train step.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "1x4", "2x2"])
def test_train_step_matches_jax_meshless(shape):
    from repro_torch.models import bridge
    ref = _ref()
    outs = [o["train"] for o in _ranks(shape)]
    for out in outs:
        for i, m in enumerate(out["metrics"]):
            assert m["grads_finite"]
            assert m["loss"] == pytest.approx(
                float(ref[f"step/{i}/loss"]), rel=TRAIN_TOL), i
            assert m["grad_norm"] == pytest.approx(
                float(ref[f"step/{i}/grad_norm"]), rel=TRAIN_TOL), i
        assert out["metrics"] == outs[0]["metrics"]
    assert all(out["global"] is None for out in outs[1:])
    got = bridge.from_jax_tree(outs[0]["global"])
    want = tp_ranks.tree_named(ref, "final/")
    assert got.keys() == want.keys()
    top = max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= PARAM_TOL * top, k
    specs = outs[0]["placement"]
    assert specs["blocks.0.attn.q_b"] == (None, "model")
    assert specs["blocks.0.attn.kv_a"] == ()
    for out in outs:
        assert out["placement"] == specs
        for n, spec in specs.items():
            if all(e is None for e in spec):   # whole on every rank
                np.testing.assert_array_equal(out["grads1"][n],
                                              outs[0]["grads1"][n])
                np.testing.assert_array_equal(out["local"][n],
                                              outs[0]["local"][n])


# --------------------------------------------------------------------------
# The train CLI under torchrun's environment.
# --------------------------------------------------------------------------
def _losses(stdout):
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"step\s+(\d+) loss (\S+)", stdout)}


def test_cli_trains_minicpm3_on_two_ranks(tmp_path):
    def cli(world, ckpt):
        outs = tp_ranks.launch(world, [
            sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--smoke", "--arch", ARCH, "--policy", "full", "--batch",
            "4", "--seq", "32", "--steps", "3", "--log-every", "1",
            "--ckpt-dir", str(ckpt), "--fresh"])
        for rc, _, err in outs:
            assert rc == 0, err[-3000:]
        return outs

    two = cli(2, tmp_path / "two")
    assert "mesh: data=1 x model=2 (2 devices)" in two[0][1]
    assert two[1][1] == ""                   # rank 1 prints nothing
    got = _losses(two[0][1])
    want = _losses(cli(1, tmp_path / "one")[0][1])
    assert sorted(got) == sorted(want) == [0, 1, 2]
    assert got == want


if __name__ == "__main__":
    if sys.argv[1] == "oracle":
        _oracle(sys.argv[2])
    else:
        tp_ranks.child({"mesh": _job_mesh}, sys.argv[1], int(sys.argv[2]),
                       int(sys.argv[3]), sys.argv[4])
