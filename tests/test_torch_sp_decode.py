"""The sequence-parallel decode collectives of ``repro_torch.distributed
.collectives`` (``sp_decode_attention``, ``sp_decode_attention_int8``,
``merge_partials``) and the decode op's partials form, against the JAX
package.

Ranks are subprocesses over gloo (``file://`` rendezvous) running this
file (``_child``), joined with a timeout; each holds only its slice of
the cache's sequence.  The oracles run in this process: the reference's
``sp_decode_attention`` / ``sp_decode_attention_int8`` on a one-device
CPU mesh (``make_mesh((1, 1), ("data", "model"))``, where the model axis
holds the whole sequence) and its ``kvq/ref.py`` ``decode_attention_ref``
over the written cache.  The data are the reference test's
(``tests/test_mesh_parallel.py`` ``TestSeqShardedDecodeCollective``): B 3,
H 4, Hkv 2, S 64, D 16, writes at ``[5, 17, 40]``.  Over 2 ranks the
writes land in both shards and rows 0 and 1 have no live position in
shard 1; over 4 the writes land in shards 0, 1 and 2, and shard 3 lies
past every length.

Tolerances: the attention outputs 1e-5 absolute (the reference test's
bound; two f32 implementations that sum in other orders: measured
1.8e-7 against JAX's int8 collective and its ref, 4.8e-7 for the plain
f32 form); the updated cache shards equal, bit for bit, the slices of
JAX's updated cache.  The in-process merge of stacked partials: 1e-6 of
the unsharded plain version (measured 1.8e-7), and a shard with no live
position contributes exactly 0 (dropping it changes no bit).
"""
from __future__ import annotations

import atexit
import functools
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
THIS = pathlib.Path(__file__).resolve()
B, H, HKV, S, D = 3, 4, 2, 64, 16
WRITE_AT = [5, 17, 40]
JOIN_S = 240
ATOL = 1e-5


def _data():
    """The reference test's inputs (numpy): q, k, v, the new token's k, v."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, HKV, S, D)).astype(np.float32)
    v = rng.normal(size=(B, HKV, S, D)).astype(np.float32)
    kn = rng.normal(size=(B, HKV, D)).astype(np.float32)
    vn = rng.normal(size=(B, HKV, D)).astype(np.float32)
    return q, k, v, kn, vn


def _bias():
    at = np.asarray(WRITE_AT)
    return np.where(np.arange(S)[None, :] < (at + 1)[:, None], 0.0,
                    -1e30).astype(np.float32)


# --------------------------------------------------------------------------
# The ranks (``python test_torch_sp_decode.py job rank world init``).
# --------------------------------------------------------------------------
def _job(rank, world):
    from repro_torch.distributed import collectives
    from repro_torch.kernels.kvq.ref import quantize_kv
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(data=1, model=world)
    q, k, v, kn, vn = (torch.from_numpy(a) for a in _data())
    s_l = S // world
    sl = slice(rank * s_l, (rank + 1) * s_l)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    new = (*quantize_kv(kn), *quantize_kv(vn))
    at = torch.tensor(WRITE_AT, dtype=torch.int32)
    out = {}
    for form, mask in (("lengths", dict(lengths=at + 1)),
                       ("bias", dict(bias=torch.from_numpy(_bias())))):
        shards = [c[:, :, sl].clone() for c in (kq, ks, vq, vs)]
        o, *upd = collectives.sp_decode_attention_int8(
            q, *shards, new, at, mesh, sm_scale=D ** -0.5, **mask)
        assert all(u is s_ for u, s_ in zip(upd, shards))     # in place
        out[form] = (o.numpy(), [u.numpy() for u in upd])
    kh, vh = (torch.repeat_interleave(t, H // HKV, dim=1) for t in (k, v))
    out["plain"] = collectives.sp_decode_attention(
        q, kh[:, :, sl], vh[:, :, sl], torch.from_numpy(_bias()), mesh,
        sm_scale=D ** -0.5).numpy()
    return out


def _child(job_path, rank, world, init_file):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = _job(rank, world)
    finally:
        dist.destroy_process_group()
    with open(f"{job_path}.{rank}", "wb") as f:
        pickle.dump(out, f)


def _join(procs):
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


@functools.lru_cache(maxsize=None)
def _ranks(world: int) -> tuple:
    """Every rank's results over ``world`` ranks (spawned once)."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="sp_decode_"))
    atexit.register(shutil.rmtree, tmp, True)
    job = tmp / "job"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(THIS), str(job), str(r), str(world),
         str(tmp / "init")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    for r, (rc, _, err) in enumerate(_join(procs)):
        assert rc == 0, f"rank {r}: {err[-3000:]}"
    outs = []
    for r in range(world):
        with open(f"{job}.{r}", "rb") as f:
            outs.append(pickle.load(f))
    return tuple(outs)


@functools.lru_cache(maxsize=None)
def _jax():
    """JAX's collectives on a one-device mesh, and its plain oracle."""
    import jax
    import jax.numpy as jnp
    from repro.distributed import collectives as jcoll
    from repro.kernels.kvq import ref as jref
    from repro.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"))
    q, k, v, kn, vn = (jnp.asarray(a) for a in _data())
    kq, ks = jref.quantize_kv(k)
    vq, vs = jref.quantize_kv(v)
    new = (*jref.quantize_kv(kn), *jref.quantize_kv(vn))
    at = jnp.asarray(WRITE_AT, jnp.int32)
    out = {}
    for form, mask in (("lengths", dict(lengths=at + 1)),
                       ("bias", dict(bias=jnp.asarray(_bias())))):
        o, *caches = jcoll.sp_decode_attention_int8(
            q, kq, ks, vq, vs, new, at, mesh, sm_scale=D ** -0.5, **mask)
        out[form] = (np.asarray(o), [np.asarray(c) for c in caches])
    written = out["lengths"][1]
    out["ref"] = np.asarray(jref.decode_attention_ref(
        q.reshape(B, HKV, H // HKV, D), *map(jnp.asarray, written), None,
        D ** -0.5, lengths=at + 1)).reshape(B, H, D)
    # the plain form takes one cache head a query head
    kh, vh = (jnp.repeat(t, H // HKV, axis=1) for t in (k, v))
    out["plain"] = np.asarray(jcoll.sp_decode_attention(
        q, kh, vh, jnp.asarray(_bias()), mesh, sm_scale=D ** -0.5))
    return out


WORLDS = [2, 4]


# --------------------------------------------------------------------------
# The tests.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("form", ["lengths", "bias"])
@pytest.mark.parametrize("world", WORLDS)
def test_int8_collective_matches_jax(world, form):
    want = _jax()
    for out in _ranks(world):                 # every rank: the same output
        got = out[form][0]
        np.testing.assert_allclose(got, want[form][0], rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, want["ref"], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(got, _ranks(world)[0][form][0])


@pytest.mark.parametrize("form", ["lengths", "bias"])
@pytest.mark.parametrize("world", WORLDS)
def test_int8_collective_writes_only_the_owning_shard(world, form):
    """Each rank's updated shards are the slices of JAX's updated cache:
    the token lands only where ``write_at`` falls, the rest untouched."""
    want = _jax()[form][1]
    s_l = S // world
    for r, out in enumerate(_ranks(world)):
        for got, full in zip(out[form][1], want):
            np.testing.assert_array_equal(
                got, full[:, :, r * s_l:(r + 1) * s_l])


@pytest.mark.parametrize("world", WORLDS)
def test_plain_collective_matches_jax(world):
    want = _jax()["plain"]
    for out in _ranks(world):
        np.testing.assert_allclose(out["plain"], want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("form", ["lengths", "bias"])
def test_partials_merge_in_process(n, form):
    """``decode_attention(partials=True)`` on each of n sequence shards,
    stacked and merged by ``merge_partials``, equals the unsharded plain
    version; the shards past a row's length give (0, NEG_INF, 0) and
    weigh exactly 0."""
    from repro_torch.distributed.collectives import merge_partials
    from repro_torch.kernels.kvq import ops, ref
    from repro_torch.kernels.tiling import NEG_INF
    q, k, v, _, _ = (torch.from_numpy(a) for a in _data())
    kq, ks = ref.quantize_kv(k)
    vq, vs = ref.quantize_kv(v)
    lengths = torch.tensor(WRITE_AT, dtype=torch.int32) + 1
    bias = torch.from_numpy(_bias())
    s_l = S // n
    parts = []
    for r in range(n):
        sl = slice(r * s_l, (r + 1) * s_l)
        mask = dict(lengths=torch.clamp(lengths - r * s_l, 0, s_l)
                    .to(torch.int32)) if form == "lengths" else \
            dict(bias=bias[:, sl].contiguous())
        parts.append(ops.decode_attention(
            q, kq[:, :, sl].contiguous(), ks[:, :, sl].contiguous(),
            vq[:, :, sl].contiguous(), vs[:, :, sl].contiguous(),
            partials=True, **mask))
    o, m, l = (torch.stack(t) for t in zip(*parts))
    whole = ops.decode_attention(q, kq, ks, vq, vs, lengths=lengths)
    got = merge_partials(o, m, l)
    assert float((got - whole).abs().max()) <= 1e-6
    for r, (o_r, m_r, l_r) in enumerate(parts):
        dead = (lengths <= r * s_l)[:, None].expand(B, H)
        assert torch.all(m_r[dead] == NEG_INF)
        assert torch.all(l_r[dead] == 0) and torch.all(o_r[dead] == 0)
    # a dead shard's weight is exactly 0: dropping it changes no bit
    for b in range(B):
        k = -(-int(lengths[b]) // s_l)              # the row's live shards
        sub = merge_partials(o[:k, b], m[:k, b], l[:k, b])
        assert torch.equal(got[b], sub), (b, k)


def test_partials_form_normalises_to_the_plain_output():
    """The CPU partials (o, m, l) divide out to ``decode_attention``'s
    output, in both mask forms."""
    from repro_torch.kernels.kvq import ops, ref
    q, k, v, _, _ = (torch.from_numpy(a) for a in _data())
    kq, ks = ref.quantize_kv(k)
    vq, vs = ref.quantize_kv(v)
    for mask in (dict(lengths=torch.tensor(WRITE_AT, dtype=torch.int32)
                      + 1), dict(bias=torch.from_numpy(_bias()))):
        o, m, l = ops.decode_attention(q, kq, ks, vq, vs, partials=True,
                                       **mask)
        want = ops.decode_attention(q, kq, ks, vq, vs, **mask)
        assert m.shape == l.shape == (B, H)
        torch.testing.assert_close(o / l[..., None], want, rtol=0,
                                   atol=1e-6)


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
