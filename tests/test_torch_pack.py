"""The port's E-D codec against the JAX package, on the CPU, from numpy
inputs: the pack kernels' plain versions (``kernels/pack/{ref,ops}.py``)
against ``pack_ops.decode/encode`` (backends ``ref`` and ``interpret``) and
the lane layout of ``decode_pallas`` / ``encode_pallas``; ``core/encoding``'s
three codecs and SBS; and ``data/pipeline``'s loader, batch for batch and
across a resume.

Every comparison is exact equality.  One known difference in the
reference, not the port: the Pallas interpret path contracts
``byte * scale + shift`` into one fused multiply-add (one rounding) where
the JAX ``ref`` path, numpy, the port's plain version and its CUDA kernel
round after the product and after the sum.  With a scale and shift whose
product or sum is exact (the default 1/255 and 0) the two agree bit for
bit; otherwise the interpret output is held to the one-rounding value of
the same bytes, exactly.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.kernels.pack import kernel as jkernel
from repro.kernels.pack import ops as jops
from repro_torch.core import encoding
from repro_torch.data import pipeline, synthetic
from repro_torch.kernels.pack import ops, ref

torch.set_num_threads(2)
SCALES = [(1.0 / 255.0, 0.0), (0.0173, -0.4217), (2.0, -1.0), (1e-3, 3.7)]
SHAPES = [(3, 5, 7, 3), (8, 32, 32, 3), (2, 17), (1, 1), (5, 3, 1)]


def _containers(shape, seed=0):
    """Random uint32 containers with the edge values set: all-ones bytes,
    the top bit alone, zero."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    flat = x.reshape(-1)
    edge = np.array([0xFFFFFFFF, 0x80000000, 0], np.uint32)[: flat.size]
    flat[: edge.size] = edge
    return x


def _one_rounding(x, scale, shift):
    """byte * scale + shift rounded once to f32 (what an FMA gives)."""
    b = np.asarray(jenc.unpack_u32_to_u8(x)).astype(np.float64)
    return (b * np.float64(np.float32(scale))
            + np.float64(np.float32(shift))).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("scale,shift", SCALES, ids=str)
def test_decode_equals_jax_ref(shape, scale, shift):
    x = _containers(shape, seed=len(shape))
    want = np.asarray(jops.decode(jnp.asarray(x), scale=scale, shift=shift,
                                  backend="ref"))
    got = ops.decode(torch.from_numpy(x), scale=scale, shift=shift)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (4 * shape[0],) + shape[1:]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.decode_ref(torch.from_numpy(x), scale, shift).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
@pytest.mark.parametrize("scale,shift", SCALES, ids=str)
def test_decode_against_jax_interpret(shape, scale, shift):
    x = _containers(shape, seed=7)
    interp = np.asarray(jops.decode(jnp.asarray(x), scale=scale, shift=shift,
                                    backend="interpret"))
    got = ops.decode(torch.from_numpy(x), scale=scale, shift=shift).numpy()
    if scale in (1.0 / 255.0, 2.0):         # product or sum exact: equal
        np.testing.assert_array_equal(got, interp)
    else:                                   # interpret rounds once (FMA)
        np.testing.assert_array_equal(interp, _one_rounding(x, scale, shift))
        np.testing.assert_array_equal(
            got, np.asarray(jenc.unpack_u32_to_u8(x)).astype(np.float32)
            * np.float32(scale) + np.float32(shift))


@pytest.mark.parametrize("r,c", [(8, 128), (16, 256), (64, 512)])
def test_lane_layout_matches_decode_pallas(r, c):
    """The Pallas kernel writes lane-major (4, R, C); the port writes image
    n = 4j + i directly: the same numbers, transposed."""
    x = _containers((r, c), seed=r)
    lanes = np.asarray(jkernel.decode_pallas(jnp.asarray(x), interpret=True))
    got = ops.decode(torch.from_numpy(x)).numpy()       # (4R, C)
    np.testing.assert_array_equal(
        got.reshape(r, 4, c).transpose(1, 0, 2), lanes)
    lanes_u8 = np.random.default_rng(c).integers(0, 256, (4, r, c),
                                                 dtype=np.uint8)
    images = np.ascontiguousarray(lanes_u8.transpose(1, 0, 2)).reshape(
        4 * r, c)                                       # image 4j + i
    np.testing.assert_array_equal(
        ops.encode(torch.from_numpy(images)).numpy(),
        np.asarray(jkernel.encode_pallas(jnp.asarray(lanes_u8),
                                         interpret=True)))


@pytest.mark.parametrize("shape", [(8, 32, 32, 3), (4, 17, 5, 1),
                                   (12, 7, 7, 3), (4, 1), (16, 3)], ids=str)
def test_encode_equals_jax(shape):
    rng = np.random.default_rng(shape[0])
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    imgs.reshape(-1)[:2] = [255, 128]
    got = ops.encode(torch.from_numpy(imgs))
    assert got.dtype == torch.uint32
    for backend in ("ref", "interpret"):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jops.encode(jnp.asarray(imgs),
                                                backend=backend)))
    np.testing.assert_array_equal(ref.encode_ref(torch.from_numpy(imgs))
                                  .numpy(), got.numpy())
    # and back: decode(encode(x)) * 255 recovers the bytes
    back = ops.decode(got, scale=1.0, shift=0.0).numpy()
    np.testing.assert_array_equal(back.astype(np.uint8), imgs)


def test_ops_reject_bad_inputs():
    with pytest.raises(TypeError, match="uint32"):
        ops.decode(torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(TypeError, match="uint8"):
        ops.encode(torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.encode(torch.zeros((6, 3), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# core/encoding: the three codecs and SBS
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 4, 6])
def test_base256_equals_jax(n):
    rng = np.random.default_rng(n)
    imgs = rng.integers(0, 256, (n, 5, 4, 3), dtype=np.uint8)
    want = jenc.encode_base256(imgs)
    got = encoding.encode_base256(imgs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(encoding.decode_base256(got, n),
                                  jenc.decode_base256(want, n))
    np.testing.assert_array_equal(encoding.decode_base256(got, n), imgs)
    i64 = encoding.encode_base256(imgs, dtype=np.int64)
    np.testing.assert_array_equal(i64, jenc.encode_base256(imgs,
                                                           dtype=np.int64))
    with pytest.raises(ValueError, match="capacity"):
        encoding.encode_base256(np.zeros((7, 2), np.uint8))
    with pytest.raises(TypeError):
        encoding.encode_base256(np.zeros((2, 2), np.int32))


@pytest.mark.parametrize("n,dtype", [(3, np.float64), (7, np.float64),
                                     (9, np.int64)])
def test_lossless_equals_jax(n, dtype):
    rng = np.random.default_rng(n)
    imgs = rng.integers(0, 256, (n, 6, 5, 3), dtype=np.uint8)
    acc, off = encoding.encode_lossless(imgs, dtype=dtype)
    jacc, joff = jenc.encode_lossless(imgs, dtype=dtype)
    np.testing.assert_array_equal(acc, jacc)
    np.testing.assert_array_equal(off, joff)
    np.testing.assert_array_equal(encoding.decode_lossless(acc, off),
                                  jenc.decode_lossless(jacc, joff))
    np.testing.assert_array_equal(encoding.decode_lossless(acc, off), imgs)


@pytest.mark.parametrize("shape", [(8, 5, 5, 3), (4, 9), (12, 2, 3)],
                         ids=str)
def test_u32_pack_numpy_and_torch_equal_jax(shape):
    rng = np.random.default_rng(len(shape))
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    imgs.reshape(-1)[:4] = 255                 # a container of all ones
    want = np.asarray(jenc.pack_u8_to_u32(imgs))
    np_got = encoding.pack_u8_to_u32(imgs)
    t_got = encoding.pack_u8_to_u32(torch.from_numpy(imgs))
    assert np_got.dtype == np.uint32 and t_got.dtype == torch.uint32
    np.testing.assert_array_equal(np_got, want)
    np.testing.assert_array_equal(t_got.numpy(), want)
    np.testing.assert_array_equal(encoding.unpack_u32_to_u8(np_got),
                                  np.asarray(jenc.unpack_u32_to_u8(want)))
    np.testing.assert_array_equal(encoding.unpack_u32_to_u8(t_got).numpy(),
                                  imgs)
    np.testing.assert_array_equal(
        encoding.unpack_u32_to_f32(t_got).numpy(),
        np.asarray(jenc.unpack_u32_to_f32(jnp.asarray(want))))
    with pytest.raises(ValueError, match="multiple"):
        encoding.pack_u8_to_u32(imgs[:3])


def test_compression_ratio_equals_jax():
    for n in (1, 4, 6):
        assert encoding.compression_ratio(n, "u32") == \
            jenc.compression_ratio(n, "u32")
        assert encoding.compression_ratio(n, "base256") == \
            jenc.compression_ratio(n, "base256")
    with pytest.raises(ValueError):
        encoding.compression_ratio(4, "zip")


@pytest.mark.parametrize("weights", [
    {c: (2.0 if c == 0 else 1.0) for c in range(10)},
    [0.5, 0.1, 0.1, 0.1, 0.2],
    {0: 1.0, 3: 3.0}], ids=["double0", "seq", "sparse"])
def test_sbs_equals_jax(weights):
    labels = np.random.default_rng(3).integers(
        0, 10 if isinstance(weights, dict) else 5, 300)
    got = [b for b, _ in encoding.sbs_batches(labels, weights, 32, 5,
                                              seed=11)]
    want = [b for b, _ in jenc.sbs_batches(labels, weights, 32, 5,
                                           seed=11)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert len(g) == 32
    with pytest.raises(ValueError, match="zero"):
        encoding.selective_batch_indices(labels, {99: 1.0}, 8,
                                         np.random.default_rng(0))


# ---------------------------------------------------------------------------
# data: make_cifar_like and the parallel E-D loader
# ---------------------------------------------------------------------------
def test_make_cifar_like_equals_jax():
    for kw in ({"n": 64}, {"n": 40, "hw": 16, "seed": 3, "channels": 1}):
        imgs, labels = synthetic.make_cifar_like(**kw)
        jimgs, jlabels = jsyn.make_cifar_like(**kw)
        assert imgs.dtype == np.uint8 and labels.dtype == np.int32
        np.testing.assert_array_equal(imgs, jimgs)
        np.testing.assert_array_equal(labels, jlabels)


def _flip(x):
    return 255 - x


@pytest.mark.parametrize("codec", ["u32", "base256", "none"])
def test_loader_yields_jax_bytes(codec):
    imgs, labels = synthetic.make_cifar_like(n=96, hw=8)
    kw = dict(codec=codec, prefetch=2,
              class_weights={c: (2.0 if c == 0 else 1.0) for c in range(10)},
              preprocess={3: _flip})
    with pipeline.ParallelEncodedLoader(imgs, labels, 12, **kw) as mine, \
            jpipe.ParallelEncodedLoader(imgs, labels, 12, **kw) as theirs:
        for _ in range(2 * mine.steps_per_epoch + 1):   # across two epochs
            (e, lb), (je, jlb) = next(mine), next(theirs)
            assert e.dtype == np.asarray(je).dtype
            np.testing.assert_array_equal(e, np.asarray(je))
            np.testing.assert_array_equal(lb, jlb)
            assert mine.state == pipeline.LoaderState(**vars(theirs.state))


def test_loader_resumes_mid_epoch():
    imgs, labels = synthetic.make_cifar_like(n=64, hw=8)
    with pipeline.ParallelEncodedLoader(imgs, labels, 8, prefetch=3) as full:
        stream = [next(full) for _ in range(13)]       # 8 per epoch
    with pipeline.ParallelEncodedLoader(imgs, labels, 8, prefetch=3) as a:
        for _ in range(5):
            next(a)
        state = a.state
    assert state == pipeline.LoaderState(0, 0, 5)
    with pipeline.ParallelEncodedLoader(imgs, labels, 8, prefetch=3,
                                        state=state) as b:
        for enc, lb in stream[5:]:
            e2, l2 = next(b)
            np.testing.assert_array_equal(e2, enc)
            np.testing.assert_array_equal(l2, lb)
        assert b.state == pipeline.LoaderState(0, 1, 5)
    with pytest.raises(ValueError, match="multiple"):
        pipeline.ParallelEncodedLoader(imgs, labels, 6)
    with pytest.raises(ValueError, match="codec"):
        pipeline.ParallelEncodedLoader(imgs, labels, 8, codec="zip")
