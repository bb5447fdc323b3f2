"""Public op: GQA decode attention over an int8 KV cache (counterpart of
``repro.kernels.kvq.ops``).

``decode_attention`` takes the deployed layout -- query heads flat, cache
pre-quantized -- and dispatches on the device: CPU tensors go to the
plain ``ref.decode_attention_ref``; CUDA tensors go to the hand-written
split-K kernel ``kernels/csrc/flash_decode.cu`` or raise.  ``lengths``
masks by position on both, and on the card it also keeps every KV tile
past a row's length from being loaded.  A dense (B, S) ``bias`` (a window
band over a non-rolling cache) goes to the kernel's own bias entry point,
``BIAS_KERNEL``, which visits every tile; its launches are counted apart.
``partials=True`` returns the unnormalised (o, m, l) of the call instead,
what a sequence-sharded decode merges across devices
(``distributed/collectives.py`` ``sp_decode_attention_int8``).

The launch (either entry point) is one operator to the dispatcher,
``repro_torch::flash_decode``, whose fake gives the kernel's outputs (the
split partials at the split count :func:`resolve_splits` picks) and whose
FLOP formula counts the products of the KV tiles a full cache's rows visit
(``tiling.decode_tile_step_counts``); the splits' merge stays in PyTorch.
Inside ``core.device.trace_for_card`` the wrapper takes fake tensors down
the card's route to that fake.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core import device
from repro_torch.kernels import build, tiling
from repro_torch.kernels.kvq import ref
from repro_torch.kernels.kvq.ref import (combine_splits,  # noqa: F401
                                         merge_splits, quantize_kv)

SUPPORTED_HEAD_DIMS = (64, 128, 160)
SUPPORTED_GROUPS = (1, 2, 3, 4, 5, 6, 8, 16)
MAX_BLOCK_S = 512

_ARGTYPES = [
    build.PTR, build.PTR, build.PTR, build.PTR, build.PTR, build.PTR,
    build.PTR, build.PTR, build.PTR, build.PTR, build.INT, build.INT,
    build.INT, build.INT, build.INT, build.INT, build.INT, build.INT,
    build.INT, build.FLOAT, build.PTR]
#: the lengths path and the dense-bias path: one source, two entry points
KERNEL = build.Kernel("flash_decode", "flash_decode", _ARGTYPES)
BIAS_KERNEL = build.Kernel("flash_decode", "flash_decode_bias", _ARGTYPES)


def resolve_splits(s: int, splits: int,
                   block_s: int = tiling.DEFAULT_DECODE_BS) -> int:
    """The split count the kernel actually runs for a length-S cache."""
    return tiling.resolve_decode_grid(s, block_s=block_s, splits=splits)[2]


def _check_cuda(qg, k_q, k_s, v_q, v_s, mask, block_s):
    """``mask`` is the (B,) int32 lengths or the (B, S) f32 bias."""
    tensors = (qg, k_q, k_s, v_q, v_s, mask)
    if not device.on_one_card(*tensors):
        raise ValueError("decode_attention: q, cache and mask must all be "
                         "on one CUDA device")
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise TypeError(f"decode_attention: the CUDA kernel takes an int8 "
                        f"cache, got {k_q.dtype}, {v_q.dtype}")
    if k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise TypeError("decode_attention: cache scales must be float32")
    if mask.dtype != (torch.int32 if mask.ndim == 1 else torch.float32):
        raise TypeError("decode_attention: lengths must be int32, bias "
                        "float32")
    b, hkv, g, d = qg.shape
    s = k_q.shape[2]
    if d not in SUPPORTED_HEAD_DIMS or g not in SUPPORTED_GROUPS:
        raise ValueError(f"decode_attention: the CUDA kernel takes head_dim "
                         f"in {SUPPORTED_HEAD_DIMS} and GQA group in "
                         f"{SUPPORTED_GROUPS}, got {d}, {g}")
    if (k_s.shape != (b, hkv, s) or v_q.shape != k_q.shape
            or v_s.shape != k_s.shape
            or mask.shape not in ((b,), (b, s))):
        raise ValueError("decode_attention: cache / scales / mask shapes "
                         "do not match")
    if block_s > MAX_BLOCK_S:
        raise ValueError(f"decode_attention: block_s {block_s} > "
                         f"{MAX_BLOCK_S}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: operands must be contiguous")
    if device.misaligned(k_q) or device.misaligned(v_q):
        raise ValueError("decode_attention: int8 cache must be 16-byte "
                         "aligned")


def decode_attention(q, k_q, k_s, v_q, v_s, *, lengths=None, bias=None,
                     sm_scale: float | None = None, splits: int = 1,
                     block_s: int | None = None, counts: bool = False,
                     partials: bool = False):
    """q: (B, H, D); cache (B, Hkv, S, D) int8 with (B, Hkv, S) f32 scales.

    ``lengths`` (B,) int32: valid cache lengths.  ``bias`` (B, S) f32: a
    dense additive mask (exclusive with ``lengths``; every tile is visited).
    ``splits`` fans the KV axis over the kernel's split-K grid.  Returns
    (B, H, D) f32, plus with ``counts`` (CUDA only) the (B, Hkv, splits)
    tiles each split executed -- the measured twin of
    ``tiling.decode_tile_step_counts`` (with ``lengths=None`` for a bias).

    With ``partials`` it returns (o (B, H, D), m (B, H), l (B, H)) f32
    instead: the accumulator left unnormalised, the running max in
    natural-log units and the softmax denominator, the call's splits
    merged by ``merge_splits`` without dividing by l.  On the card the
    kernel writes its m / l at every split count, one split included; a
    row with no live position here (length 0) reads no tile and gives
    (0, NEG_INF, 0)."""
    if lengths is not None and bias is not None:
        raise ValueError("decode_attention: lengths and bias are exclusive")
    b, h, d = q.shape
    _, hkv, s, _ = k_q.shape
    if hkv == 0 or h % hkv:
        raise ValueError(f"decode_attention: {h} query heads are not a "
                         f"multiple of {hkv} KV heads")
    g = h // hkv
    sm = float(sm_scale) if sm_scale is not None else d ** -0.5
    qg = q.float().reshape(b, hkv, g, d)
    if not device.on_card(q):
        if counts:
            raise ValueError("decode_attention: counts come from the CUDA "
                             "kernel; the plain version runs no tiles")
        if partials:
            o, m, l = ref.decode_partials_ref(qg, k_q, k_s, v_q, v_s, bias,
                                              sm, lengths=lengths)
            return o.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h)
        out = ref.decode_attention_ref(qg, k_q, k_s, v_q, v_s, bias, sm,
                                       lengths=lengths)
        return out.reshape(b, h, d)
    if bias is None and lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    mask = lengths if bias is None else bias
    block_s = tiling.DEFAULT_DECODE_BS if block_s is None else block_s
    qg = qg.contiguous()
    if device.misaligned(qg):       # the kernel bulk-copies q's rows
        qg = qg.clone()
    _check_cuda(qg, k_q, k_s, v_q, v_s, mask, block_s)
    if counts:
        out, m_p, l_p, cnt = _launch(qg, k_q, k_s, v_q, v_s, mask, sm,
                                     block_s, splits, partials, counts=True)
    else:
        out, *ml = _decode_op(qg, k_q, k_s, v_q, v_s, mask, sm, block_s,
                              splits, partials)
        m_p, l_p = ml or (None, None)
        cnt = None
    if partials:
        o, m, l = merge_splits(out, m_p, l_p)
        out = (o.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h))
        return (out, cnt) if counts else out
    if m_p is not None:
        out = combine_splits(out, m_p, l_p, torch.float32)
    out = out.reshape(b, h, d)
    return (out, cnt) if counts else out


def _outputs(qg, s: int, block_s: int, splits: int,
             partials: bool) -> list:
    """The shapes of the kernel's f32 output buffers for qg (B, Hkv, G, D)
    and a length-S cache: the output (B, Hkv, G, D) at one split without
    ``partials``, else the split partials (B, Hkv, n_sp, G, D) and their m
    and l (B, Hkv, n_sp, G), n_sp the split count :func:`resolve_splits`
    picks."""
    b, hkv, g, d = qg.shape
    n_sp = resolve_splits(s, splits, block_s)
    if n_sp == 1 and not partials:
        return [(b, hkv, g, d)]
    return [(b, hkv, n_sp, g, d), (b, hkv, n_sp, g), (b, hkv, n_sp, g)]


def _launch(qg, k_q, k_s, v_q, v_s, mask, sm_scale, block_s, splits,
            partials, counts: bool = False):
    """One launch of the entry point ``mask`` selects (lengths (B,) int32:
    ``KERNEL``; bias (B, S) f32: ``BIAS_KERNEL``) on inputs
    :func:`decode_attention` has checked -> (out, m, l, counts), m / l None
    at one split without ``partials``, counts None without ``counts``."""
    b, hkv, g, d = qg.shape
    s = k_q.shape[2]
    kernel = KERNEL if mask.ndim == 1 else BIAS_KERNEL
    bs, ns, n_sp, spt = tiling.resolve_decode_grid(s, block_s=block_s,
                                                   splits=splits)
    dev = qg.device
    shapes = _outputs(qg, s, block_s, splits, partials)
    bufs = [torch.empty(sh, dtype=torch.float32, device=dev)
            for sh in shapes]
    out, m_p, l_p = (bufs + [None, None])[:3]
    cnt = (torch.empty((b, hkv, n_sp), dtype=torch.int32, device=dev)
           if counts else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    kernel(qg.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
           v_s.data_ptr(), mask.data_ptr(), out.data_ptr(), ptr(m_p),
           ptr(l_p), ptr(cnt), b, hkv, g, s, d, bs, ns, spt, n_sp, sm_scale,
           torch.cuda.current_stream(dev).cuda_stream)
    return out, m_p, l_p, cnt


def decode_flops(b: int, hkv: int, g: int, s: int, d: int, *,
                 block_s: int = tiling.DEFAULT_DECODE_BS,
                 splits: int = 1) -> int:
    """The decode kernel's products (QK^T and PV, 4 G D BS a KV tile and
    KV head) over the tiles of ``b`` rows of a full length-S cache
    (``tiling.decode_tile_step_counts`` without lengths): what
    ``plan.decode_tile_report`` counts a layer."""
    c = tiling.decode_tile_step_counts(s, None, block_s=block_s,
                                       splits=splits)
    return b * c["visited"] * 4 * g * d * c["bs"] * hkv


# The launch as one operator to the dispatcher: the dry run's trace reaches
# its fake, and torch.utils.flop_counter its formula.  Called only from
# decode_attention, on checked inputs; returns [out] at one split without
# partials, else [out, m, l] (the partials the caller merges).
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_decode(Tensor qg, Tensor k_q, Tensor k_s, Tensor v_q, "
            "Tensor v_s, Tensor mask, float sm_scale, int block_s, "
            "int splits, bool partials) -> Tensor[]")
_LIB.impl("flash_decode",
          lambda *args: [t for t in _launch(*args)[:3] if t is not None],
          "CompositeExplicitAutograd")


@torch.library.register_fake("repro_torch::flash_decode", lib=_LIB)
def _(qg, k_q, k_s, v_q, v_s, mask, sm_scale, block_s, splits, partials):
    if device.card_trace_active():
        device.count_card_call(KERNEL if mask.ndim == 1 else BIAS_KERNEL)
    shapes = _outputs(qg, k_q.shape[2], block_s, splits, partials)
    return [qg.new_empty(sh, dtype=torch.float32) for sh in shapes]


@register_flop_formula(torch.ops.repro_torch.flash_decode)
def _(qg, k_q, k_s, v_q, v_s, mask, sm_scale, block_s, splits, partials, *,
      out_shape=None, **kw):
    b, hkv, g, d = qg
    return decode_flops(b, hkv, g, k_q[2], d, block_s=block_s, splits=splits)


_decode_op = torch.ops.repro_torch.flash_decode.default
