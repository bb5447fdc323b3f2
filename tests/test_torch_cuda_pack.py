"""The E-D codec's CUDA kernels (``kernels/csrc/pack.cu``) against their
plain PyTorch versions, and the ResNet through the decode kernel against
the CPU, on the card.  Marked ``cuda``: without a CUDA device (and nvcc)
every test here skips; on the H100 run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_pack.py
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.kernels.pack import ref as pack_ref

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rel, floor=1e-6):
    """max |got - want| <= rel * max |want| + floor, compared in f32."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * scale + floor, (err, rel * scale + floor)


def _words(shape, dev, seed):
    """Random uint32 containers on the card, the top bit and all-ones
    bytes among them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen, device=dev,
                      dtype=torch.int64).to(torch.int32)
    flat = w.view(-1)
    edge = torch.tensor([-1, -2 ** 31], dtype=torch.int32)
    flat[:2] = edge[:flat.numel()]             # a one-container batch too
    return w.view(torch.uint32)


# (containers, pixels): the vector path (P % 4 == 0), the scalar path
# (ragged P), one container, and the two chip_smoke shapes
PACK_SHAPES = [(8, (32, 32, 3)), (3, (5, 7, 3)), (1, (1,)), (2, (17,)),
               (4, (512, 512, 3))]


@pytest.mark.parametrize("m,rest", PACK_SHAPES, ids=str)
@pytest.mark.parametrize("scale,shift", [(1 / 255.0, 0.0),
                                         (0.0173, -0.4217)], ids=str)
def test_pack_decode_kernel_equals_plain(dev, m, rest, scale, shift):
    x = _words((m,) + rest, dev, m)
    got = pack_ops.decode(x, scale=scale, shift=shift)
    want = pack_ref.decode_ref(x, scale, shift)
    assert got.shape == (4 * m,) + rest and got.dtype == torch.float32
    assert torch.equal(got, want)                  # bit-exact, no FMA
    assert torch.equal(got.cpu(), pack_ref.decode_ref(x.cpu(), scale, shift))


@pytest.mark.parametrize("m,rest", PACK_SHAPES, ids=str)
def test_pack_encode_kernel_equals_plain(dev, m, rest):
    gen = torch.Generator(device=dev).manual_seed(m + 1)
    imgs = torch.randint(0, 256, (4 * m,) + rest, generator=gen,
                         device=dev, dtype=torch.uint8)
    got = pack_ops.encode(imgs)
    want = pack_ref.encode_ref(imgs)
    assert got.dtype == torch.uint32 and got.shape == (m,) + rest
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    back = pack_ops.decode(got, scale=1.0, shift=0.0)
    assert torch.equal(back, imgs.float())


def test_pack_kernels_take_unaligned_views(dev):
    """A view 4 bytes into its storage is not 16-byte aligned: the kernels
    take the one-container-per-thread path and agree all the same."""
    x = _words((9, 8), dev, 3)[1:]
    got = pack_ops.decode(x, scale=0.5, shift=-2.0)
    assert torch.equal(got, pack_ref.decode_ref(x, 0.5, -2.0))
    imgs = torch.arange(4 * 9 * 8, device=dev).to(torch.uint8).view(36, 8)
    assert torch.equal(pack_ops.encode(imgs[4:]).view(torch.int32),
                       pack_ref.encode_ref(imgs[4:]).view(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        pack_ops.decode(_words((4, 6), dev, 1)[:, ::2])


def test_cnn_card_vs_cpu_through_the_decode_kernel(dev):
    from repro_torch.core import encoding
    from repro_torch.models import cnn
    cfg = cnn.ResNetConfig("narrow", (1, 1, 1, 1), (8, 16, 32, 64),
                           groups=4, stem_stride=2)
    cpu = cnn.init_params(cfg, 0, device="cpu")
    card = {n: p.to(dev) for n, p in cpu.items()}
    gen = torch.Generator().manual_seed(0)
    u8 = torch.randint(0, 256, (8, 16, 16, 3), generator=gen,
                       dtype=torch.uint8)
    packed = encoding.pack_u8_to_u32(u8)
    labels = torch.randint(0, 10, (8,), generator=gen)
    before = pack_ops.DECODE.launches
    losses = {}
    for name, params, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
        for p in params.values():
            p.requires_grad_()
        loss, _ = cnn.loss_fn(params, cfg, packed.to(d), labels.to(d),
                              decode=True)
        loss.backward()
        losses[name] = float(loss.detach())
    assert pack_ops.DECODE.launches == before + 1
    assert abs(losses["card"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])
    for n, p in card.items():
        _close(p.grad.cpu(), cpu[n].grad, 1e-3)
