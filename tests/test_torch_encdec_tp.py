"""The encoder-decoder (whisper-base) over a mesh's model axis: the
encoder's layers, each decoder layer's cross-attention and the GELU MLP
split over the axis, trained through ``build_train_step`` on batches with
frames and served through ``make_serve_steps``, against the JAX package.

Ranks are gloo subprocesses running this file (``tests/tp_ranks.py``),
joined with a timeout; the reference's numbers come from ONE more
subprocess (``_oracle``) with 4 emulated devices, into an ``.npz``.  The
smoke config (2 + 2 layers, 4 / 2 heads of 16, d_ff 128, 32 frames),
weights from JAX's ``init_params(PRNGKey(0))`` with the MLPs' biases
``b1`` / ``b2`` drawn from a seed (the reference starts them at zero, so
a bias added per rank, or not at all, would not show), carried across
with ``bridge.load_jax_params(mesh=)``, frames and tokens from numpy
seeds, policy ``full``.  Heads mode on (1, 2); sequence mode on (1, 4)
(2 KV heads): the attention, the cross-attention and their K / V whole
on every rank, the MLPs split:

  * ``forward``'s logits with frames on (1, 2) and (1, 4) against JAX's
    meshless ``forward`` and the reference's ``forward(mesh=)``, and the
    encoder's output (``run_encoder(mesh=)``) against JAX's;
  * the train step through ``build_train_step`` on batches with frames,
    3 AdamW steps on (1, 2), (1, 4) and (2, 2) (the frames split over the
    data axis with the tokens), against JAX's meshless step at the global
    batch (4 x 16, 32 frames a row): losses, grad norms, final parameters;
    every replicated leaf (``b2``, the norms, the attention and the
    cross-attention in sequence mode) bit-equal across ranks, its
    first-step gradient and its value after the steps alike;
  * ``make_serve_steps``: the prefill of 2 x 12 prompts with frames into
    a 20-slot cache, then 8 greedy decode steps each taking the encoder's
    output (``enc_out``), on (1, 2) and (1, 4), against the port's
    meshless steps and JAX's greedy lockstep (``kvq_backend="ref"``):
    tokens exact;
  * the placement: ``xattn`` follows ``attn`` (split in heads mode, whole
    in sequence mode), ``b1`` split with ``w1``'s columns, ``b2`` whole,
    ``frames`` split over DP;
  * the CLIs under torchrun's environment: ``launch/serve.py --arch
    whisper-base`` (lockstep, 2 ranks) prints rank 0's stream, equal to a
    1-rank run's; ``launch/train.py --arch whisper-base`` exits 2 on one
    device (its synthetic stream has no frames; on a model axis:
    ``test_torch_tp_train.py``).

Tolerances (as ``test_torch_moe_tp.py``'s), the largest value measured
on this tree beside each: logits 1e-6 of the largest |logit| against the
meshless JAX forward (7.1e-7) and the reference's mesh (6.5e-7), the
encoder's output 1e-6 of its largest (3.7e-7); the train step's losses
and grad norms 1e-5 relative (1.6e-7 / 2.2e-7), the final parameters
1e-4 of the largest parameter (1.5e-5); the serve steps' logits 1e-5 of
the largest against the meshless steps (5.4e-7) and JAX's lockstep
(7.0e-7).
"""
from __future__ import annotations

import functools
import pickle
import sys

import numpy as np
import pytest
import torch

import tp_ranks

THIS = tp_ranks.pathlib.Path(__file__).resolve()
WH = "whisper-base"
STEPS, B, S = 3, 4, 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
FWD = (2, 16)                  # forward's tokens
PROMPT, GEN = (2, 12), 8       # serve steps: prompts, decode steps
S_MAX = PROMPT[1] + GEN
SHAPES = [(1, 2), (1, 4), (2, 2)]


def _cfg(jax=False):
    if jax:
        from repro import configs
    else:
        from repro_torch import configs
    return configs.smoke_config(WH)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape) \
        .astype(np.int32)


def _frames(b, seed):
    cfg = _cfg()
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)


def _batches():
    out = []
    for i in range(STEPS):
        toks = _tokens((B, S + 1), 10 + i)
        out.append({"tokens": toks[:, :-1].copy(),
                    "labels": toks[:, 1:].copy(),
                    "frames": _frames(B, 20 + i)})
    return out


@functools.lru_cache(maxsize=None)
def _jax_tree():
    """JAX's smoke weights, the MLPs' biases drawn from a seed."""
    import jax
    from repro.models import transformer as jtf
    tree = jax.tree.map(np.asarray, jtf.init_params(
        _cfg(jax=True), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(21)
    for part in ("blocks", "enc_blocks"):
        for name in ("b1", "b2"):
            leaf = tree[part]["ffn"][name]
            tree[part]["ffn"][name] = (0.1 * rng.standard_normal(
                leaf.shape)).astype(np.float32)
    return tree


# --------------------------------------------------------------------------
# The reference's numbers, in one subprocess with 4 emulated devices.
# --------------------------------------------------------------------------
def _oracle(out_path):
    import jax
    import jax.numpy as jnp
    from repro.core.mixed_precision import LossScale, Policy
    from repro.launch.mesh import make_mesh
    from repro.models import transformer as jtf
    from repro.optim import adamw as jadamw
    from repro.train import serve_step as jss
    from repro.train.train_step import TrainConfig, build_train_step
    jcfg = _cfg(jax=True)
    params = jax.tree.map(jnp.asarray, _jax_tree())
    out = {}
    frames = jnp.asarray(_frames(FWD[0], 1))
    batch = {"tokens": jnp.asarray(_tokens(FWD, 1)), "frames": frames}
    out["fwd"] = jtf.forward(params, jcfg, batch)[0]
    out["enc"] = jtf._run_encoder(params, jcfg, frames, Policy.full())
    for n in (2, 4):
        mesh = make_mesh((1, n), ("data", "model"))
        out[f"mesh{n}"] = jax.jit(
            lambda p, b, m=mesh: jtf.forward(p, jcfg, b, mesh=m)[0]
        )(params, batch)
    frames = jnp.asarray(_frames(PROMPT[0], 2))
    enc = jtf._run_encoder(params, jcfg, frames, Policy.full())
    prefill = jax.jit(jss.build_prefill_step(jcfg, policy_name="full",
                                             s_max=S_MAX))
    decode = jax.jit(jss.build_decode_step(jcfg, policy_name="full"))
    logits, cache = prefill(params, {"tokens": jnp.asarray(
        _tokens(PROMPT, 2)), "frames": frames})
    seq, fed = [logits], []
    for _ in range(GEN):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(tok)
        logits, cache = decode(params, cache, tok, enc)
        seq.append(logits)
    out["serve/logits"], out["serve/tokens"] = jnp.stack(seq), \
        jnp.stack(fed, 1)
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
    return tp_ranks.tmpdir("encdec_tp_")


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
# The ranks (run in subprocesses: ``python test_torch_encdec_tp.py ...``).
# --------------------------------------------------------------------------
def _serve(model, cfg, mesh=None):
    """The prefill with frames and GEN greedy decode steps taking the
    encoder's output: ``make_serve_steps`` on ``mesh``, the meshless
    ``serve_step`` builders without -> (logits (GEN + 1, B, V), the fed
    tokens (B, GEN))."""
    from repro_torch.core.mixed_precision import Policy
    from repro_torch.models import transformer
    from repro_torch.train import serve_step
    batch = {"tokens": torch.from_numpy(_tokens(PROMPT, 2)),
             "frames": torch.from_numpy(_frames(PROMPT[0], 2))}
    if mesh is None:
        prefill = serve_step.build_prefill_step(cfg, policy_name="full",
                                                s_max=S_MAX)
        decode = serve_step.build_decode_step(cfg, policy_name="full")
    else:
        prefill, _ = serve_step.make_serve_steps(
            cfg, mesh, batch, kind="prefill", policy_name="full",
            s_max=S_MAX)
        decode, _ = serve_step.make_serve_steps(
            cfg, mesh, {"tokens_t": batch["tokens"][:, 0]}, kind="decode",
            policy_name="full")
    with torch.no_grad():
        enc = transformer.run_encoder(model, cfg, batch["frames"],
                                      Policy.full(), mesh)
        logits, cache = prefill(model, batch)
        seq, fed = [logits], []
        for _ in range(GEN):
            tok = logits.argmax(-1).to(torch.int32)
            fed.append(tok)
            logits, cache = decode(model, cache, tok, enc)
            seq.append(logits)
    return torch.stack(seq).numpy(), torch.stack(fed, 1).numpy()


def _train(cfg, tree, mesh):
    from repro_torch.models import bridge
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (TrainConfig, build_train_step,
                                              init_loss_scale)
    model = bridge.load_jax_params(cfg, tree, device="cpu",
                                   mesh=mesh).requires_grad_()
    opt = adamw.init(dict(model.named_parameters()))
    tc = TrainConfig(policy="full", opt=adamw.AdamWConfig(**OPT))
    seen, real = [], adamw.update

    def update(c, grads, *args, **kwargs):
        if not seen:
            seen.append({n: g.detach().clone() for n, g in grads.items()})
        return real(c, grads, *args, **kwargs)

    adamw.update = update
    step = build_train_step(cfg, tc, mesh=mesh)
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
    cfg = _cfg()
    mesh = Mesh(data=shape[0], model=shape[1])
    out = {}
    if shape[0] == 1:
        model = bridge.load_jax_params(cfg, tree, device="cpu", mesh=mesh)
        frames = torch.from_numpy(_frames(FWD[0], 1))
        with torch.no_grad():
            out["logits"] = transformer.forward(
                model, cfg, {"tokens": torch.from_numpy(_tokens(FWD, 1)),
                             "frames": frames},
                policy=Policy.full(), mesh=mesh)[0].numpy()
            out["enc"] = transformer.run_encoder(
                model, cfg, frames, Policy.full(), mesh).numpy()
        out["serve"] = _serve(model, cfg, mesh)
    out["train"] = _train(cfg, tree, mesh)
    return out


# --------------------------------------------------------------------------
# Forward and serving.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("world", [2, 4])
def test_forward_with_frames_matches_jax(world):
    ref = _ref()
    want = ref["fwd"]
    top = np.abs(want).max()
    ranks = _ranks((1, world))
    for out in ranks:
        np.testing.assert_array_equal(out["logits"], ranks[0]["logits"])
        assert np.abs(out["logits"] - want).max() <= 1e-6 * top
        assert np.abs(out["logits"] - ref[f"mesh{world}"]).max() \
            <= 1e-6 * top
        np.testing.assert_array_equal(out["enc"], ranks[0]["enc"])
        assert np.abs(out["enc"] - ref["enc"]).max() \
            <= 1e-6 * np.abs(ref["enc"]).max()


@functools.lru_cache(maxsize=None)
def _meshless_serve():
    from repro_torch.models import bridge
    cfg = _cfg()
    return _serve(bridge.load_jax_params(cfg, _jax_tree(), device="cpu"),
                  cfg)


@pytest.mark.parametrize("world", [2, 4])
def test_serve_steps_with_enc_out_match_jax(world):
    ref = _ref()
    want, want_tok = ref["serve/logits"], ref["serve/tokens"]
    alone, alone_tok = _meshless_serve()
    np.testing.assert_array_equal(alone_tok, want_tok)
    top = np.abs(want).max()
    assert np.abs(alone - want).max() <= 1e-5 * top
    for out in _ranks((1, world)):
        logits, tokens = out["serve"]
        np.testing.assert_array_equal(tokens, want_tok)
        assert np.abs(logits - alone).max() <= 1e-5 * top
        assert np.abs(logits - want).max() <= 1e-5 * top


# --------------------------------------------------------------------------
# The train step.
# --------------------------------------------------------------------------
def _tree_named(prefix: str) -> dict:
    return tp_ranks.tree_named(_ref(), prefix)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "1x4", "2x2"])
def test_train_step_with_frames_matches_jax_meshless(shape):
    from repro_torch.models import bridge
    ref = _ref()
    outs = [o["train"] for o in _ranks(shape)]
    for out in outs:
        for i, m in enumerate(out["metrics"]):
            assert m["grads_finite"]
            for k in ("loss", "grad_norm"):
                assert m[k] == pytest.approx(float(ref[f"step/{i}/{k}"]),
                                             rel=1e-5), (i, k)
        assert out["metrics"] == outs[0]["metrics"]
    assert all(out["global"] is None for out in outs[1:])
    got = bridge.from_jax_tree(outs[0]["global"])
    want = _tree_named("final/")
    assert got.keys() == want.keys()
    top = max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= 1e-4 * top, k
    specs = outs[0]["placement"]
    for out in outs:
        assert out["placement"] == specs
        for n, spec in specs.items():
            if all(e is None for e in spec):   # whole on every rank
                np.testing.assert_array_equal(out["grads1"][n],
                                              outs[0]["grads1"][n])
                np.testing.assert_array_equal(out["local"][n],
                                              outs[0]["local"][n])


# --------------------------------------------------------------------------
# Placement.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,mode", [(2, "heads"), (4, "seq")])
def test_cross_attention_follows_the_attention(n, mode):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer
    specs = transformer.param_placement(_cfg(), Mesh(data=1, model=n))
    for pre in ("blocks.1", "enc_blocks.0"):
        for leaf in ("wq", "wk", "wv", "wo"):
            split = ((None, "model") if leaf != "wo" else ("model", None))
            want = split if mode == "heads" else ()
            assert specs[f"{pre}.attn.{leaf}"] == want, (pre, leaf)
            if pre == "blocks.1":
                assert specs[f"{pre}.xattn.{leaf}"] == want, leaf
        assert specs[f"{pre}.ffn.w1"] == (None, "model")
        assert specs[f"{pre}.ffn.b1"] == ("model",)
        assert specs[f"{pre}.ffn.w2"] == ("model", None)
        assert specs[f"{pre}.ffn.b2"] == ()


def test_frames_split_over_the_data_axis():
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train import train_step as ts
    cfg = _cfg()
    b = {k: torch.from_numpy(v) for k, v in _batches()[0].items()}
    mesh = Mesh(data=2, model=2)
    specs = shd.batch_specs(cfg, b, mesh)
    assert specs["frames"] == ("data", None, None)
    assert specs["tokens"] == ("data", None)
    for r in range(4):
        rows = ts.local_batch(cfg, b, mesh, rank=r)
        half = (r // 2) * (B // 2)
        np.testing.assert_array_equal(rows["frames"],
                                      b["frames"][half:half + B // 2])
        np.testing.assert_array_equal(rows["tokens"],
                                      b["tokens"][half:half + B // 2])


# --------------------------------------------------------------------------
# The CLIs under torchrun's environment.
# --------------------------------------------------------------------------


def test_cli_lockstep_serves_whisper_on_two_ranks(tmp_path):
    def cli(world, out):
        return tp_ranks.launch(world, [
            sys.executable, str(THIS), "cli", str(out), "--device", "cpu",
            "--smoke", "--arch", WH, "--policy", "full", "--gen", "6",
            "--prompt-len", "16"])

    two = cli(2, tmp_path / "two")
    for rc, _, err in two:
        assert rc == 0, err[-3000:]
    assert "encoder: 2 layers over 32 zero frames" in two[0][1]
    assert two[1][1] == "" and not (tmp_path / "two.1").exists()
    (rc, _, err), = cli(1, tmp_path / "one")
    assert rc == 0, err[-3000:]
    with open(tmp_path / "two.0", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "one.0", "rb") as f:
        np.testing.assert_array_equal(got, pickle.load(f))


def test_train_cli_refuses_whisper_on_one_device(tmp_path):
    """On any mesh, one device too (``test_torch_tp_train.py`` holds the
    model axis of 2): the trainer's synthetic stream has no frames."""
    (rc, _, err), = tp_ranks.launch(1, [
        sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
        "--smoke", "--arch", WH, "--steps", "1", "--ckpt-dir",
        str(tmp_path / "ck"), "--fresh"])
    assert rc == 2 and "frames" in err


if __name__ == "__main__":
    if sys.argv[1] == "oracle":
        _oracle(sys.argv[2])
    elif sys.argv[1] == "cli":
        raise SystemExit(tp_ranks.lockstep_child(sys.argv[2], sys.argv[3:]))
    else:
        tp_ranks.child({"mesh": _job_mesh}, sys.argv[1], int(sys.argv[2]),
                       int(sys.argv[3]), sys.argv[4])
