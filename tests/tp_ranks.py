"""Gloo ranks as subprocesses, for the tests that hold the port's mesh
paths against the JAX package (``test_torch_ssm_tp.py``,
``test_torch_encdec_tp.py``).

A test file runs its own ranks: :func:`start` pickles a job, starts
``world`` processes of the file (``python FILE JOB RANK WORLD INIT``),
each of which calls :func:`child` with the file's job functions, joins a
gloo group over a ``file://`` rendezvous, runs its job and pickles the
result beside the job.  :func:`results` joins them with a timeout (all
killed if one hangs or fails).  :func:`start_oracle` runs the file's JAX
oracle (``python FILE oracle OUT``) with 4 emulated devices, set before
``jax`` is imported.  :func:`launch` starts a CLI under ``torchrun``'s
environment; :func:`lockstep_child` records what the serve CLI's
lockstep served on each rank.  :func:`tree_named` reads a JAX tree back
from an oracle's flattened ``.npz``.
"""
from __future__ import annotations

import atexit
import os
import pathlib
import pickle
import re
import shutil
import socket
import subprocess
import sys
import tempfile

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JOIN_S = 300


def env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu", **extra)


def tmpdir(prefix: str) -> pathlib.Path:
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=prefix))
    atexit.register(shutil.rmtree, tmp, True)
    return tmp


def join(procs) -> list:
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


def start(this, tmp, kind: str, world: int, **args):
    """``world`` ranks of ``this`` running job ``kind`` -> a handle for
    :func:`results`."""
    job_dir = pathlib.Path(tempfile.mkdtemp(dir=tmp))
    job = job_dir / "job"
    with open(job, "wb") as f:
        pickle.dump({"kind": kind, "args": args}, f)
    procs = [subprocess.Popen(
        [sys.executable, str(this), str(job), str(r), str(world),
         str(job_dir / "init")], env=env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    return job, procs


def results(handle) -> list:
    """Every rank's result, in rank order (each rank's exit asserted)."""
    job, procs = handle
    for r, (rc, _, err) in enumerate(join(procs)):
        assert rc == 0, f"rank {r}: {err[-3000:]}"
    outs = []
    for r in range(len(procs)):
        with open(f"{job}.{r}", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def child(jobs: dict, job_path, rank, world, init_file) -> None:
    """One rank: join the gloo group, run ``jobs[kind](rank, world,
    **args)``, write its result."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = jobs[job["kind"]](rank, world, **job["args"])
        dist.barrier()           # no rank tears gloo down under another
    finally:
        dist.destroy_process_group()
    with open(f"{job_path}.{rank}", "wb") as f:
        pickle.dump(out, f)


def start_oracle(this, path):
    return subprocess.Popen(
        [sys.executable, str(this), "oracle", str(path)],
        env=env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, cmd: list) -> list:
    """``cmd`` as ``world`` ranks under torchrun's environment (one plain
    process for 1) -> [(returncode, stdout, stderr)]."""
    envs = [{}] if world == 1 else [dict(
        RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
        MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        for port in [str(free_port())] for r in range(world)]
    return join([subprocess.Popen(cmd, env=env(**e), text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE) for e in envs])


def tree_named(ref: dict, prefix: str) -> dict:
    """{port parameter name: array} of the JAX tree flattened into ``ref``
    under ``prefix`` (its keys ``jax.tree_util.keystr`` paths)."""
    from repro_torch.models import bridge
    tree: dict = {}
    for k, v in ref.items():
        if not k.startswith(prefix):
            continue
        node, keys = tree, re.findall(r"\['([^']+)'\]", k[len(prefix):])
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = v
    return bridge.from_jax_tree(tree)


def lockstep_child(out_path, argv) -> int:
    """``launch.serve.main(argv)`` with the lockstep's tokens written to
    ``out_path.<rank>`` (a rank that never serves writes nothing)."""
    from repro_torch.launch import serve
    real = serve.lockstep

    def recording(*args, **kwargs):
        r = real(*args, **kwargs)
        with open(f"{out_path}.{os.environ.get('RANK', '0')}", "wb") as f:
            pickle.dump(r["tokens"], f)
        return r

    serve.lockstep = recording
    return serve.main(argv)
