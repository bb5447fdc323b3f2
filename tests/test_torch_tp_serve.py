"""Serving over a mesh's model axis (``ServeEngine(mesh=)``,
``train/serve_step.py``, ``SlotPool(mesh=)``, ``launch/serve.py
--max-model``) against the JAX package.

Ranks are subprocesses over gloo (``file://`` rendezvous) running this
file (``_child``), joined with a timeout.  Smoke llama3-8b (4 / 2 heads of
16, d_ff 128, vocab 256, 2 layers), policy ``full``, weights from JAX's
``init_params(PRNGKey(0))`` cut per rank by ``bridge.load_jax_params(
mesh=)``: heads mode on (1, 2) (one KV head a rank) and sequence mode on
(1, 4) (the 2 KV heads do not divide 4: each rank holds 16 of the 64
cache slots).  The reference's own sharded-engine tests need 8 devices
and skip here; they assert its sharded engine token-exact against its
meshless one, so the oracle is JAX's meshless ``ServeEngine``
(``kv_backend="ref"``) in this process:

  * the engine on the reference test's 5-request trace
    (``tests/test_mesh_parallel.py`` ``TestServeParity``: ``max_slots``
    4, ``max_len`` 64, buckets (8, 16)): every rank's streams equal JAX's
    and the port's meshless engine's, the pool audit clean;
  * ``build_prefill_step(s_max=)`` and ``build_decode_step`` under
    teacher forcing (JAX's greedy tokens fed to both), their logits within
    1e-5 of the largest |logit| of JAX's meshless steps (measured 9.3e-7
    heads, 8.2e-7 sequence; the row-parallel sums add the ranks' f32
    partials in another order);
  * ``SlotPool.bytes_per_slot_per_device`` equal to JAX's
    ``serve_capacity_report(mesh=)`` figure on the same (abstract) mesh;
  * a rank's block of ``init_params(mesh=)`` and of
    ``load_jax_params(mesh=)`` equal to the slices of the meshless model
    (``transformer.param_shard_specs``; the attention projections whole
    in sequence mode), and ``make_serve_steps``' placement the same specs;
  * ``make_serve_steps`` over a data axis takes this rank's rows and
    refuses a prefill batch whose rows do not split (the decode's tokens
    are then taken whole, as the reference's), equal to the meshless
    steps' rows within ``torch.testing``'s f32 defaults;
  * ``grow_cache(mesh=)``, ``place_seq`` and ``scatter_request(
    seq_offset=)`` lay a cache out by global position: bit-equal to the
    slices of the meshless grown cache;
  * the CLI under torchrun's environment: 2 ranks with ``--device cpu
    --smoke --engine --policy full`` print the mesh banner and the ``kv cache sharded
    over 'heads'`` line, rank 1 prints nothing, and both ranks' streams
    equal a 1-rank run's; ``--engine`` with an MLA arch (minicpm3-4b) or
    an SSM arch (mamba2-130m), which the engine takes on no mesh, on a
    model axis of 2 exits 2, naming it not engine-eligible (the MoE archs
    serve there since the MoE splits its experts:
    ``tests/test_torch_moe_tp.py``; the MLA case keeps its id ``moe``;
    lockstep serves every arch unsharded on any mesh:
    ``tests/test_torch_ssm_tp.py``; the fleet serves there:
    ``tests/test_torch_fleet_tp.py``).
"""
from __future__ import annotations

import atexit
import functools
import os
import pathlib
import pickle
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
ARCH = "llama3-8b"
KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
          policy_name="full")
PB, PS, S_MAX, STEPS = 2, 16, 32, 4        # the serve steps' batch
JOIN_S = 300
RTOL = 1e-5


def _trace_args():
    """The reference test's trace: (prompt_len, arrival_step) pairs."""
    rng = np.random.default_rng(0)
    lens = [(5, 0), (9, 0), (13, 2), (3, 4), (7, 5)]
    return [(rng.integers(1, 200, (pl,)).astype(np.int32), st)
            for pl, st in lens]


def _prompts():
    return np.random.default_rng(1).integers(
        0, 256, (PB, PS)).astype(np.int32)


# --------------------------------------------------------------------------
# The ranks (``python test_torch_tp_serve.py job rank world init``).
# --------------------------------------------------------------------------
def _job_serve(rank, world, tree, forced):
    from repro_torch import configs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import bridge, transformer
    from repro_torch.serve import ServeEngine, TraceRequest
    from repro_torch.train import serve_step
    cfg = configs.smoke_config(ARCH)
    mesh = Mesh(data=1, model=world)
    model = bridge.load_jax_params(cfg, tree, device="cpu", mesh=mesh)
    out = {"loaded": {k: v.numpy().copy()
                      for k, v in model.named_parameters()}}
    out["init"] = {k: v.numpy().copy() for k, v in transformer.init_params(
        cfg, 0, device="cpu", mesh=mesh).named_parameters()}
    eng = ServeEngine(model, cfg, mesh=mesh, **KW)
    eng.warmup()
    summary = eng.run([TraceRequest(prompt=p, max_new_tokens=6,
                                    arrival_step=st)
                       for p, st in _trace_args()])
    out["tokens"] = {r.rid: list(r.tokens) for r in eng._requests_done}
    out["n_done"] = summary["n_done"]
    out["audit"] = eng.pool.audit()
    out["pool"] = {"occupancy": eng.pool.occupancy,
                   "per_device": eng.pool.bytes_per_slot_per_device(),
                   "per_slot": eng.pool.bytes_per_slot(),
                   "k_shape": tuple(eng.pool.cache["k"].shape),
                   "seq_offset": eng.pool.seq_offset}
    # the serve steps under teacher forcing
    prefill = serve_step.build_prefill_step(cfg, policy_name="full",
                                            s_max=S_MAX, mesh=mesh)
    decode = serve_step.build_decode_step(cfg, policy_name="full",
                                          mesh=mesh)
    with torch.no_grad():
        logits, cache = prefill(model, {"tokens": torch.from_numpy(
            _prompts())})
        steps = [logits.numpy()]
        for t in range(STEPS):
            logits, cache = decode(model, cache,
                                   torch.from_numpy(forced[:, t]))
            steps.append(logits.numpy())
    out["steps"] = np.stack(steps)
    out["step_k_shape"] = tuple(cache["k"].shape)
    _, placement = serve_step.make_serve_steps(
        cfg, mesh, {"tokens": (PB, PS)}, kind="prefill")
    out["placement"] = placement
    return out


def _child(job_path, rank, world, init_file):
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = _job_serve(rank, world, **job)
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
    """Wait for every process with a timeout; kill them all if one hangs.
    -> [(returncode, stdout, stderr)]."""
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=JOIN_S)
            outs.append((p.returncode, o, e))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank did not finish within {JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


# --------------------------------------------------------------------------
# The oracles (this process) and the ranks' results, each made once.
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax():
    """JAX's meshless engine streams and teacher-forced serve-step logits,
    the weights as numpy, and the port's meshless engine streams."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import transformer as jtf
    from repro.serve import ServeEngine as JServeEngine
    from repro.serve.trace import TraceRequest as JTrace
    from repro.train import serve_step as jss
    from repro_torch import configs
    from repro_torch.models import bridge
    from repro_torch.serve import ServeEngine, TraceRequest
    jcfg = jconfigs.smoke_config(ARCH)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    jeng = JServeEngine(params, jcfg, kv_backend="ref", **KW)
    jeng.warmup()
    jeng.run([JTrace(prompt=list(p), max_new_tokens=6, arrival_step=st)
              for p, st in _trace_args()])
    jtok = {r.rid: [int(t) for t in r.tokens] for r in jeng._requests_done}
    cfg = configs.smoke_config(ARCH)
    eng = ServeEngine(bridge.load_jax_params(cfg, tree, device="cpu"), cfg,
                      **KW)
    eng.warmup()
    eng.run([TraceRequest(prompt=p, max_new_tokens=6, arrival_step=st)
             for p, st in _trace_args()])
    ptok = {r.rid: list(r.tokens) for r in eng._requests_done}
    prefill = jax.jit(jss.build_prefill_step(jcfg, policy_name="full",
                                             s_max=S_MAX))
    decode = jax.jit(jss.build_decode_step(jcfg, policy_name="full",
                                           kvq_backend="ref"))
    logits, cache = prefill(params, {"tokens": jnp.asarray(_prompts())})
    steps, forced = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        forced.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok)
        steps.append(np.asarray(logits))
    return {"tree": tree, "jtok": jtok, "ptok": ptok,
            "steps": np.stack(steps), "forced": np.stack(forced, 1)}


@functools.lru_cache(maxsize=None)
def _ranks(world: int) -> tuple:
    oracle = _jax()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tp_serve_"))
    atexit.register(shutil.rmtree, tmp, True)
    job = tmp / "job"
    with open(job, "wb") as f:
        pickle.dump({"tree": oracle["tree"], "forced": oracle["forced"]}, f)
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
    return tuple(outs)


MODES = [pytest.param(2, id="heads-1x2"), pytest.param(4, id="seq-1x4")]


# --------------------------------------------------------------------------
# The tests.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("world", MODES)
def test_engine_token_exact_on_every_rank(world):
    oracle = _jax()
    assert oracle["ptok"] == oracle["jtok"]
    assert len(oracle["jtok"]) == 5
    for out in _ranks(world):
        assert out["tokens"] == oracle["jtok"]
        assert out["n_done"] == 5
        assert out["pool"]["occupancy"] == 0
        assert out["audit"]["allocs"] == out["audit"]["frees"]


@pytest.mark.parametrize("world", MODES)
def test_pool_holds_this_ranks_block(world):
    """Heads mode: 1 of 2 KV heads a rank, every slot position; sequence
    mode: both heads, 16 of 64 positions from ``16 r``."""
    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh
    cfg = configs.smoke_config(ARCH)
    mode = shd.serve_kv_shard(Mesh(data=1, model=world), cfg.n_kv, 64)
    assert mode == ("heads" if world == 2 else "seq")
    for r, out in enumerate(_ranks(world)):
        hkv, s = (1, 64) if mode == "heads" else (2, 16)
        assert out["pool"]["k_shape"] == (2, 4, hkv, s, 16)
        assert out["pool"]["seq_offset"] == (0 if mode == "heads" else 16 * r)
        # the serve steps' cache: s_max 32 cut the same way
        assert out["step_k_shape"] == (2, PB, hkv, S_MAX if mode == "heads"
                                       else S_MAX // world, 16)


@pytest.mark.parametrize("world", MODES)
def test_serve_steps_match_jax_meshless(world):
    want = _jax()["steps"]
    top = np.abs(want).max()
    for out in _ranks(world):
        assert out["steps"].shape == want.shape
        assert np.abs(out["steps"] - want).max() <= RTOL * top
        np.testing.assert_array_equal(out["steps"], _ranks(world)[0]["steps"])


@pytest.mark.parametrize("world", MODES)
def test_bytes_per_slot_per_device_equal_jax(world):
    from repro import configs as jconfigs
    from repro import plan as jplan
    from repro.launch import mesh as jmesh
    jm = jmesh.abstract_mesh((1, world), ("data", "model"))
    rep = jplan.serve_capacity_report(jconfigs.smoke_config(ARCH), 64,
                                      2**20, mesh=jm)
    for out in _ranks(world):
        assert out["pool"]["per_device"] == rep["bytes_per_slot_per_device"]
        assert out["pool"]["per_slot"] == rep["bytes_per_slot"]


@pytest.mark.parametrize("source", ["init", "loaded"])
@pytest.mark.parametrize("world", MODES)
def test_rank_block_equals_slice_of_meshless_model(world, source):
    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import Mesh, coords
    from repro_torch.models import bridge, transformer
    cfg = configs.smoke_config(ARCH)
    mesh = Mesh(data=1, model=world)
    whole = {k: v.numpy() for k, v in (
        transformer.init_params(cfg, 0, device="cpu") if source == "init"
        else bridge.load_jax_params(cfg, _jax()["tree"], device="cpu")
    ).named_parameters()}
    specs = transformer.param_shard_specs(
        cfg, {k: v.shape for k, v in whole.items()}, mesh)
    # heads mode splits the projections by whole heads; sequence mode
    # keeps them whole; the FFN and the vocab split in both
    attn = specs["blocks.0.attn.wq"]
    assert attn == ((None, "model") if world == 2 else ())
    assert specs["blocks.0.ffn.w_down"] == ("model", None)
    assert specs["embed"] == ("model", None)
    for r, out in enumerate(_ranks(world)):
        got = out[source]
        assert got.keys() == whole.keys()
        assert out["placement"] == specs
        for k, w in whole.items():
            np.testing.assert_array_equal(
                got[k], shd.shard_leaf(w, specs[k], mesh, coords(mesh, r)))


# --------------------------------------------------------------------------
# The CLI under torchrun's environment.
# --------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(world, out_path, *args):
    # policy full: under bf16 each rank's partial products round to bf16
    # before the row-parallel sum, so a near-tie may fall the other way
    argv = ["--device", "cpu", "--smoke", "--engine", "--requests", "6",
            "--max-len", "64", "--policy", "full", *args]
    cmd = [sys.executable, str(THIS), "--cli", str(out_path), *argv]
    if world == 1:
        return _join([subprocess.Popen(cmd, env=_env(), text=True,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE)])
    port = str(_free_port())
    return _join([subprocess.Popen(cmd, env=_env(
        RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
        MASTER_ADDR="127.0.0.1", MASTER_PORT=port), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)])


def _streams(path, rank):
    with open(f"{path}.{rank}", "rb") as f:
        return pickle.load(f)


def test_cli_two_ranks_serve_the_one_rank_streams(tmp_path):
    r0, r1 = _cli(2, tmp_path / "two")
    assert r0[0] == 0 and r1[0] == 0, r0[2][-2000:] + r1[2][-2000:]
    assert "mesh: data=1 x model=2 (2 devices)" in r0[1]
    assert "mesh: data=1 x model=2, kv cache sharded over 'heads'" in r0[1]
    assert "MB/slot/device" in r0[1]
    assert r1[1] == ""                      # rank 1 prints nothing
    (rc, out, err), = _cli(1, tmp_path / "one")
    assert rc == 0, err[-2000:]
    assert "mesh: data=1 x model=1 (1 devices)" in out
    one = _streams(tmp_path / "one", 0)
    assert len(one) == 6
    assert _streams(tmp_path / "two", 0) == one
    assert _streams(tmp_path / "two", 1) == one


@pytest.mark.parametrize("args,needle", [
    (("--arch", "minicpm3-4b"), "not engine-eligible"),
    (("--arch", "mamba2-130m"), "the engine does not take mamba2-130m"),
], ids=["moe", "ssm_engine"])
def test_cli_refuses_on_a_model_axis(tmp_path, args, needle):
    outs = _cli(2, tmp_path / "x", *args)
    assert [o[0] for o in outs] == [2, 2]
    assert needle in outs[0][2]


def test_make_serve_steps_take_this_ranks_rows():
    """Over a data axis of 2 (rank 0, no group: the model axis is 1) the
    prefill takes rows 0-1 of 4 and refuses 3 rows, which do not split;
    the decode takes rows 0-1 of 4 tokens and all of 3 (the reference's
    ``tok_shard``).  Each equals the meshless steps' rows."""
    from repro_torch import configs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer
    from repro_torch.train import serve_step
    cfg = configs.smoke_config(ARCH)
    mesh = Mesh(data=2, model=1)
    model = transformer.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, PS)).astype(np.int32))
    kw = dict(policy_name="full")
    prefill = serve_step.build_prefill_step(cfg, **kw)
    decode = serve_step.build_decode_step(cfg, **kw)
    step_p, _ = serve_step.make_serve_steps(
        cfg, mesh, {"tokens": (4, PS)}, kind="prefill", **kw)
    step_d, _ = serve_step.make_serve_steps(
        cfg, mesh, {"cache": None, "tokens_t": (4,)}, kind="decode", **kw)
    with torch.no_grad():
        for rows, want_rows in ((4, slice(0, 2)), (3, slice(0, 3))):
            logits, cache = prefill(model, {"tokens": tokens[:rows]})
            if rows % 2:
                with pytest.raises(ValueError, match="splits dim 0"):
                    step_p(model, {"tokens": tokens[:rows]})
            else:
                got, _ = step_p(model, {"tokens": tokens[:rows]})
                torch.testing.assert_close(got, logits[want_rows])
            nxt = logits.argmax(-1).to(torch.int32)
            local = {k: v if k == "pos" else v[:, want_rows]
                     for k, v in cache.items()}
            got, _ = step_d(model, local, nxt)
            want, _ = decode(model, cache, nxt)
            torch.testing.assert_close(got, want[want_rows])


@pytest.mark.parametrize("world", MODES)
def test_cache_block_by_global_position(world):
    """``grow_cache(mesh=)`` (rank 0's block), ``place_seq`` at every
    rank's offset and ``scatter_request(seq_offset=)`` lay a cache out by
    global position: each block equals the slice of the meshless grown
    cache, and a meshless pool filled at offset 0 equals one filled with
    the grown cache."""
    from repro_torch import configs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer
    from repro_torch.serve import SlotPool, scatter_request
    cfg = configs.smoke_config(ARCH)
    mesh = Mesh(data=1, model=world)
    model = transformer.init_params(cfg, 0, device="cpu")
    with torch.no_grad():
        _, aux = transformer.forward(
            model, cfg, {"tokens": torch.from_numpy(_prompts()[:1])},
            build_cache=True)
    cache = aux["cache"]
    grown = transformer.grow_cache(cache, S_MAX)
    off, s_l = transformer.seq_block(cfg, mesh, S_MAX)
    assert (off, s_l) == ((0, S_MAX) if world == 2 else (0, S_MAX // world))
    block = transformer.grow_cache(cache, S_MAX, cfg=cfg, mesh=mesh)
    for name, ax in transformer.CACHE_SEQ_AXES.items():
        if name not in cache:
            continue
        torch.testing.assert_close(block[name],
                                   grown[name].narrow(ax, 0, s_l),
                                   rtol=0, atol=0)
        for r in range(S_MAX // s_l):
            got = transformer.place_seq(
                torch.full_like(grown[name].narrow(ax, 0, s_l), 9),
                cache[name], ax, r * s_l)
            torch.testing.assert_close(
                got, grown[name].narrow(ax, r * s_l, s_l), rtol=0, atol=0)
    a, b = (SlotPool(cfg, 2, S_MAX, device="cpu") for _ in range(2))
    scatter_request(a.cache, cache, 1, PS, seq_offset=0)
    scatter_request(b.cache, grown, 1, PS)
    for name in a.cache:
        torch.testing.assert_close(a.cache[name], b.cache[name], rtol=0,
                                   atol=0)


if __name__ == "__main__":
    if sys.argv[1] == "--cli":
        raise SystemExit(_cli_child(sys.argv[2], sys.argv[3:]))
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
