"""ResNet family, the paper's own experiment models (Figs. 8-10)
(counterpart of ``repro.models.cnn``).

Built as an explicit *layer list* so ``checkpoint_sequential`` applies as
in the paper: segments of the sequential stack are recomputed, only
segment inputs are stored.  GroupNorm replaces BatchNorm (stateless), as
in the JAX package.

Parameters are a flat dict {name: tensor}: ``stem.{w,s,b}``,
``blocks.<i>.{w1,w2[,w3],s1,b1,...,proj}``, ``head.{w,b}``.  Convolution
weights are OIHW (the JAX package's are HWIO; ``bridge`` converts).
Images are NHWC at the public functions, as in the JAX package; inside,
the layers run NCHW tensors in ``channels_last`` memory, so the decode
kernel's NHWC output becomes the stem's input as a view, without a copy.

The first layer is the E-D *decode layer* when the input is a packed
uint32 batch (paper II.A.2: "a custom deep learning layer to decode").
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.pack import ops as pack_ops


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    arch_id: str = "resnet18"
    stage_sizes: Sequence[int] = (2, 2, 2, 2)
    widths: Sequence[int] = (64, 128, 256, 512)
    bottleneck: bool = False
    num_classes: int = 10
    groups: int = 8
    stem_stride: int = 1          # 1 for CIFAR, 2 for 512x512 memory runs


def resnet18(num_classes=10, **kw) -> ResNetConfig:
    return ResNetConfig("resnet18", (2, 2, 2, 2), (64, 128, 256, 512),
                        False, num_classes, **kw)


def resnet50(num_classes=10, **kw) -> ResNetConfig:
    return ResNetConfig("resnet50", (3, 4, 6, 3), (64, 128, 256, 512),
                        True, num_classes, **kw)


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: (low, high).  A stride-2
    3x3 conv on an even size pads (0, 1), not (1, 1)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """x (N, C, H, W), w (O, I, kh, kw); "SAME" padding as the JAX
    package's ``lax.conv_general_dilated``.  A strided 1x1 conv (the
    shortcut projections) needs no padding and reads every stride-th
    pixel: it runs as a 1x1 conv of that subsample, the same numbers (and
    PyTorch's CPU backward of a strided 1x1 conv on a channels_last input
    crashes)."""
    x = x.to(w.dtype)
    if w.shape[2] == w.shape[3] == 1 and stride > 1:
        return F.conv2d(x[:, :, ::stride, ::stride], w)
    (ph0, ph1), (pw0, pw1) = (same_padding(x.shape[2], w.shape[2], stride),
                              same_padding(x.shape[3], w.shape[3], stride))
    if ph0 == ph1 and pw0 == pw1:
        return F.conv2d(x, w, stride=stride, padding=(ph0, pw0))
    return F.conv2d(F.pad(x, (pw0, pw1, ph0, ph1)), w, stride=stride)


def _group_norm(x, scale, bias, groups):
    """GroupNorm in f32, cast back to the input's dtype."""
    g = min(groups, x.shape[1])
    return F.group_norm(x.float(), g, scale.float(), bias.float(),
                        eps=1e-5).to(x.dtype)


def _conv_init(gen, kh, kw, cin, cout, **kw_):
    # the JAX package's dense_init over HWIO with in_axis=0 (fan-in kh),
    # divided by sqrt(kh * kw): the same distribution, not the same numbers
    std = (1.0 / kh) ** 0.5 / (kh * kw) ** 0.5
    return torch.randn((cout, cin, kh, kw), generator=gen, **kw_) * std


def init_params(cfg: ResNetConfig, seed: int = 0, *, device="cuda",
                dtype=torch.float32) -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed``.  Same
    distributions as the JAX init; not the same numbers."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=dtype, device=device)
    w0 = cfg.widths[0]
    p = {"stem.w": _conv_init(gen, 3, 3, 3, w0, **kw),
         "stem.s": torch.ones(w0, **kw), "stem.b": torch.zeros(w0, **kw)}
    cin = w0
    i = 0
    for stage, (n_blocks, width) in enumerate(zip(cfg.stage_sizes,
                                                  cfg.widths)):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            cout = width * (4 if cfg.bottleneck else 1)
            pre = f"blocks.{i}."
            if cfg.bottleneck:
                p[pre + "w1"] = _conv_init(gen, 1, 1, cin, width, **kw)
                p[pre + "w2"] = _conv_init(gen, 3, 3, width, width, **kw)
                p[pre + "w3"] = _conv_init(gen, 1, 1, width, cout, **kw)
                dims = (width, width, cout)
            else:
                p[pre + "w1"] = _conv_init(gen, 3, 3, cin, width, **kw)
                p[pre + "w2"] = _conv_init(gen, 3, 3, width, cout, **kw)
                dims = (width, cout)
            for j, dc in enumerate(dims):
                p[pre + f"s{j+1}"] = torch.ones(dc, **kw)
                p[pre + f"b{j+1}"] = torch.zeros(dc, **kw)
            if stride != 1 or cin != cout:
                p[pre + "proj"] = _conv_init(gen, 1, 1, cin, cout, **kw)
            cin = cout
            i += 1
    p["head.w"] = torch.randn((cin, cfg.num_classes), generator=gen,
                              **kw) * cin ** -0.5
    p["head.b"] = torch.zeros(cfg.num_classes, **kw)
    return p


def num_layer_fns(cfg: ResNetConfig) -> int:
    """Chain length ``layer_fns`` produces (stem + blocks + head): the
    ``n_layers`` a RematPlan for this model must be solved for."""
    return 2 + sum(cfg.stage_sizes)


def block_strides(cfg: ResNetConfig) -> list[int]:
    strides = []
    for stage, n_blocks in enumerate(cfg.stage_sizes):
        for b in range(n_blocks):
            strides.append(2 if (b == 0 and stage > 0) else 1)
    return strides


def _block_fn(params, i: int, cfg: ResNetConfig, stride: int):
    pre = f"blocks.{i}."

    def bp(name):
        return params[pre + name]

    def fn(x):
        g = cfg.groups
        if cfg.bottleneck:
            h = F.relu(_group_norm(_conv(x, bp("w1")), bp("s1"), bp("b1"), g))
            h = F.relu(_group_norm(_conv(h, bp("w2"), stride), bp("s2"),
                                   bp("b2"), g))
            h = _group_norm(_conv(h, bp("w3")), bp("s3"), bp("b3"), g)
        else:
            h = F.relu(_group_norm(_conv(x, bp("w1"), stride), bp("s1"),
                                   bp("b1"), g))
            h = _group_norm(_conv(h, bp("w2")), bp("s2"), bp("b2"), g)
        sc = _conv(x, bp("proj"), stride) if pre + "proj" in params else x
        return F.relu(h + sc)

    return fn


def layer_fns(params: dict, cfg: ResNetConfig) -> list[Callable]:
    """The sequential layer list ``checkpoint_sequential`` consumes; each
    takes and returns an (N, C, H, W) tensor, the head (N, classes)."""
    fns: list[Callable] = [
        lambda x: F.relu(_group_norm(
            _conv(x, params["stem.w"], cfg.stem_stride),
            params["stem.s"], params["stem.b"], cfg.groups))
    ]
    fns += [_block_fn(params, i, cfg, st)
            for i, st in enumerate(block_strides(cfg))]

    def head(x):
        x = x.mean((2, 3))
        return x @ params["head.w"] + params["head.b"]

    fns.append(head)
    return fns


def forward(params, cfg: ResNetConfig, images, *, remat=None,
            decode: bool = False):
    """images: f32 (B, H, W, C), or packed u32 (B/4, H, W, C) with
    ``decode`` (the E-D decode layer runs first, on the device the batch
    is on).

    ``remat`` is ``repro_torch.core.checkpoint.CheckpointConfig`` (None or
    ``enabled=False``: the standard pipeline).  With ``remat.plan`` set,
    S-C segments follow the planner's (possibly non-uniform) boundaries;
    otherwise layers are grouped uniformly, ``segment_size`` layers per
    segment.
    """
    x = pack_ops.decode(images) if decode else images
    x = x.permute(0, 3, 1, 2)             # NHWC -> NCHW, channels_last
    fns = layer_fns(params, cfg)
    if remat is not None and remat.enabled:
        from repro_torch.core.checkpoint import checkpoint_sequential
        if remat.plan is not None:  # the plan carries its own policy
            return checkpoint_sequential(fns, plan=remat.plan,
                                         save_names=remat.save_names)(x)
        n_seg = -(-len(fns) // max(1, remat.segment_size))
        if n_seg > 1:
            return checkpoint_sequential(fns, n_seg, policy=remat.policy,
                                         save_names=remat.save_names)(x)
    for f in fns:
        x = f(x)
    return x


def loss_fn(params, cfg: ResNetConfig, images, labels, *, remat=None,
            decode: bool = False):
    """-> (mean NLL, {"acc": accuracy}), both 0-d f32 tensors."""
    logits = forward(params, cfg, images, remat=remat, decode=decode)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll, {"acc": acc}
