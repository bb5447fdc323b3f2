"""Public flash-attention op (counterpart of ``repro.kernels.flash.ops``).

The op dispatches on the device of its tensors: CPU tensors go to the
plain versions in ``ref.py``; CUDA tensors go to hand-written kernels, or
raise.  The forward and the backward's dQ and dKV each have two designs,
chosen by dtype and head_dim (:func:`fwd_route`, :func:`bwd_route`): the
bf16 policy at head_dim 64 / 128 / 160 goes to the tensor-core kernels of
``kernels/csrc/flash_fwd_sm90.cu`` and ``flash_bwd_sm90.cu`` (wgmma on
TMA-fed rings), every other supported combination to the FMA kernels of
``kernels/csrc/flash_fwd.cu`` and ``flash_bwd.cu``, which also runs the
backward's delta.  Nothing falls back from one to another.  The TPU
path's 128-lane padding and its shape fallback do not carry over: the
kernels mask the ragged tail themselves.

``flash_attention`` is differentiable: a ``torch.autograd.Function``
saves (q, k, v, o, m, l) -- O(S*D) per head, never the S x S
probabilities -- and its backward recomputes the probabilities from the
f32 row stats (the counterpart of the JAX package's ``custom_vjp``).

The forward (``repro_torch::flash_fwd``) and the backward's three kernels
(``repro_torch::flash_bwd``) are each one operator to the dispatcher,
with a fake that gives the kernels' outputs and a FLOP formula that
counts the products of the tiles the kernels visit
(``torch.utils.flop_counter``).  Inside ``core.device.trace_for_card``
the wrappers take fake tensors down the card's route to those fakes.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core import device
from repro_torch.kernels import build, tiling
from repro_torch.kernels.flash import ref

BQ = BK = 64                       # the kernel's q and KV tile sizes
SUPPORTED_HEAD_DIMS = (16, 64, 128, 160)   # 16: the smoke configurations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = build.Kernel("flash_fwd", "flash_fwd", [
    build.PTR, build.PTR, build.PTR, build.PTR, build.PTR, build.PTR,
    build.PTR, build.INT, build.INT, build.INT, build.INT, build.INT,
    build.INT, build.INT, build.INT, build.FLOAT, build.PTR])
FWD_SM90 = build.Kernel("flash_fwd_sm90", "flash_fwd_sm90", KERNEL.argtypes)
BWD_DELTA = build.Kernel("flash_bwd", "flash_bwd_delta", [
    build.PTR, build.PTR, build.PTR, build.INT, build.INT, build.INT,
    build.INT, build.INT, build.PTR])
_BWD_ARGS = [build.PTR] * 7 + [build.INT] * 10 + [build.FLOAT, build.PTR]
BWD_DQ = build.Kernel("flash_bwd", "flash_bwd_dq",
                      _BWD_ARGS[:7] + [build.PTR, build.PTR] + _BWD_ARGS[7:])
BWD_DKV = build.Kernel("flash_bwd", "flash_bwd_dkv",
                       _BWD_ARGS[:7] + [build.PTR] * 3 + _BWD_ARGS[7:])
BWD_DQ_SM90 = build.Kernel("flash_bwd_sm90", "flash_bwd_dq_sm90",
                           BWD_DQ.argtypes)
BWD_DKV_SM90 = build.Kernel("flash_bwd_sm90", "flash_bwd_dkv_sm90",
                            BWD_DKV.argtypes)
#: (residual q/k/v/o, cotangent dO, gradients) dtypes the backward kernels
#: take: the f32 policy, the bf16 policy, and bf16-saved residuals under
#: f32 compute (``Policy.resid_bf16``)
BWD_DTYPES = ((torch.float32, torch.float32, torch.float32),
              (torch.bfloat16, torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32, torch.float32))
SM90_DTYPES = (torch.bfloat16, torch.bfloat16, torch.bfloat16)
SM90_HEAD_DIMS = (64, 128, 160)


def fwd_route(dtype, d: int) -> str:
    """Which hand-written kernel takes a CUDA forward of ``dtype`` q, k, v
    at head_dim ``d``: ``"sm90"`` (``flash_fwd_sm90.cu``, tensor cores, P
    rounded to bf16 before P V) for bf16 at head_dim 64, 128 or 160;
    ``"fma"`` (``flash_fwd.cu``, f32 arithmetic) for f32 at every supported
    head_dim -- held to 1e-4 of the f32 plain version, which bf16 products cannot
    meet -- and for bf16 at head_dim 16, the only head_dim at which
    ``flash_fwd.cu`` takes bf16.  Raises for anything neither takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention_fwd: the CUDA kernels take f32 or "
                        f"bf16 q, k, v, got {dtype}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS} for the CUDA kernels")
    return "sm90" if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS \
        else "fma"


def bwd_route(q_dtype, do_dtype, grad_dtype, d: int) -> str:
    """Which hand-written dQ / dKV kernels take a CUDA backward with these
    (residual, dO, gradient) dtypes at head_dim ``d``: ``"sm90"`` (the
    tensor-core kernels, bf16 operands for P, dS and dO) for the all-bf16
    combination at head_dim 64, 128 or 160; ``"fma"`` (f32 arithmetic) for
    the other supported ones -- f32 and bf16-residual gradients are held to
    1e-4 of the f32 plain version, which bf16 products cannot meet -- and
    for head_dim 16, the only head_dim at which ``flash_bwd.cu`` takes the
    all-bf16 combination.  Raises for anything neither takes."""
    combo = (q_dtype, do_dtype, grad_dtype)
    if combo not in BWD_DTYPES:
        raise TypeError(f"flash_attention_bwd: the CUDA kernels take "
                        f"(residual, dO, gradient) dtypes in {BWD_DTYPES}, "
                        f"got {combo}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS} for the CUDA kernels")
    return "sm90" if combo == SM90_DTYPES and d in SM90_HEAD_DIMS else "fma"


def expected_counts(s: int, *, causal: bool = True, window: int = 0,
                    kv_len: int | None = None) -> list[int]:
    """Per-q-tile KV steps the kernel executes for a length-S row: the
    analytic twin from ``tiling.kv_visits`` on the 64-padded length."""
    n_q = -(-s // BQ)
    return tiling.kv_visits(n_q * BQ, bq=BQ, bk=BK, causal=causal,
                            window=window, kv_len=s if kv_len is None
                            else kv_len)


def expected_bwd_counts(s: int, group: int, *, causal: bool = True,
                        window: int = 0, kv_len: int | None = None
                        ) -> tuple[list[int], list[int]]:
    """Analytic twins of the backward kernels' counters for a length-S
    row: KV tiles the dQ kernel executes per 64-row q tile (the forward's
    ``tiling.kv_visits``), and (q tile, query head) steps the dKV kernel
    executes per 64-row KV tile: ``group`` x ``tiling.q_visits``, 0 for a
    KV tile that lies wholly at or past ``kv_len``."""
    n = -(-s // BQ) * BQ
    kv_len = s if kv_len is None else kv_len
    kw = dict(bq=BQ, bk=BK, causal=causal, window=window, kv_len=kv_len)
    return (tiling.kv_visits(n, **kw),
            [group * c for c in tiling.q_visits(n, **kw)])


def fwd_flops(bh: int, s: int, d: int, *, causal: bool = True,
              window: int = 0) -> int:
    """The forward kernel's products (QK^T and PV, 4 BQ BK D a visited
    tile) over the tiles it visits for ``bh`` rows of length S: the
    forward term of ``plan.flash_attn_flop_report``."""
    return 4 * bh * BQ * BK * d * sum(expected_counts(s, causal=causal,
                                                      window=window))


def bwd_flops(bh: int, s: int, d: int, *, causal: bool = True,
              window: int = 0, kv_len: int | None = None) -> int:
    """The backward kernels' products over the tiles they visit: dQ's
    score recompute, dP and dS K (6 BQ BK D a tile), dKV's recompute,
    P^T dO, dP and dS^T Q (8); the delta's row sums are no product.  The
    backward terms of ``plan.flash_attn_flop_report``."""
    dq, dkv = expected_bwd_counts(s, 1, causal=causal, window=window,
                                  kv_len=kv_len)
    return bh * BQ * BK * d * (6 * sum(dq) + 8 * sum(dkv))


def _check_cuda(q, k, v) -> str:
    """Check a CUDA forward's inputs; return :func:`fwd_route`'s route."""
    if not device.on_one_card(q, k, v):
        raise ValueError("flash_attention_fwd: q, k, v must all be on the "
                         "same device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: the CUDA kernels take q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    route = fwd_route(q.dtype, q.shape[-1])
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k, v must be contiguous")
    if route == "sm90" and any(device.misaligned(t) for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: the tensor-core kernel loads "
                         "q, k, v by TMA and needs them 16-byte aligned")
    return route


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        sm_scale: float | None = None,
                        kv_len: int | None = None, counts: bool = False):
    """Flat layout: q (BH, S, D); k, v (BHkv, S, D) with BH = BHkv * group.

    Returns (o, m, l): o (BH, S, D) in q's dtype and the f32 row stats
    (BH, S) the backward will read.  With ``counts`` (CUDA only) also a
    (BH, n_q) int32 tensor of KV tiles executed per 64-row q tile, to be
    held against :func:`expected_counts`."""
    bh, s, d = q.shape
    bhkv = k.shape[0]
    if k.shape != (bhkv, s, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: k{tuple(k.shape)}, "
                         f"v{tuple(v.shape)} do not match q{tuple(q.shape)}")
    if bhkv == 0 or bh % bhkv:
        raise ValueError(f"flash_attention_fwd: {bh} query rows are not a "
                         f"multiple of {bhkv} KV rows (GQA)")
    kv_len = s if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= s:
        raise ValueError(f"flash_attention_fwd: kv_len {kv_len} outside "
                         f"[0, {s}]")
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    if not device.on_card(q):
        if counts:
            raise ValueError("flash_attention_fwd: counts come from the CUDA "
                             "kernel; the plain version runs no tiles")
        return ref.flash_fwd_ref(q, k, v, causal=causal, window=window,
                                 sm_scale=scale, kv_len=kv_len)
    kern = FWD_SM90 if _check_cuda(q, k, v) == "sm90" else KERNEL
    o = torch.empty_like(q)
    m = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    l = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    cnt = (torch.empty((bh, -(-s // BQ)), dtype=torch.int32, device=q.device)
           if counts else None)
    kern(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
         m.data_ptr(), l.data_ptr(), None if cnt is None else cnt.data_ptr(),
         bh, bhkv, s, d, _DTYPES[q.dtype], int(bool(causal)), int(window),
         kv_len, scale, _stream(q))
    return (o, m, l, cnt) if counts else (o, m, l)


def _check_bwd_cuda(q, k, v, o, m, l, do, grad_dtypes):
    tensors = (q, k, v, o, m, l, do)
    if not device.on_one_card(*tensors):
        raise ValueError("flash_attention_bwd: every input must be on one "
                         "CUDA device")
    if len(set(grad_dtypes)) != 1:
        raise TypeError(f"flash_attention_bwd: the CUDA kernels write dq, "
                        f"dk, dv in one dtype, got {grad_dtypes}")
    combo = (q.dtype, do.dtype, grad_dtypes[0])
    if (k.dtype != q.dtype or v.dtype != q.dtype or o.dtype != q.dtype
            or combo not in BWD_DTYPES):
        raise TypeError(f"flash_attention_bwd: the CUDA kernels take "
                        f"(residual, dO, gradient) dtypes in {BWD_DTYPES}, "
                        f"got q/k/v/o {q.dtype}/{k.dtype}/{v.dtype}/"
                        f"{o.dtype}, dO {do.dtype}, grads {grad_dtypes}")
    if m.dtype != torch.float32 or l.dtype != torch.float32:
        raise TypeError("flash_attention_bwd: m and l must be float32")
    route = bwd_route(*combo, q.shape[-1])
    if not all(t.is_contiguous() for t in (q, k, v, o, m, l)):
        raise ValueError("flash_attention_bwd: q, k, v, o, m, l must be "
                         "contiguous")
    if route == "sm90" and any(device.misaligned(t) for t in (q, k, v, do)):
        raise ValueError("flash_attention_bwd: the tensor-core kernels load "
                         "q, k, v, dO by TMA and need them 16-byte aligned")
    return route


def flash_attention_bwd(q, k, v, o, m, l, do, *, causal: bool = True,
                        window: int = 0, sm_scale: float | None = None,
                        kv_len: int | None = None, grad_dtypes=None,
                        counts: bool = False):
    """Backward from the forward's residuals -> (dq, dk, dv).

    q, o, do: (BH, S, D); k, v: (BHkv, S, D); m, l: (BH, S) f32 from
    :func:`flash_attention_fwd`.  Gradients come out in ``grad_dtypes``
    (dq, dk, dv; default the dtypes of q, k, v), written from f32
    accumulators.  ``do`` may be strided (autograd hands over a transposed
    view); it is made contiguous here.  With ``counts`` (CUDA only) also
    the dQ kernel's (BH, n_q) and the dKV kernel's (BHkv, n_k) int32
    counters, to be held against :func:`expected_bwd_counts`."""
    bh, s, d = q.shape
    bhkv = k.shape[0]
    if (k.shape != (bhkv, s, d) or v.shape != k.shape or o.shape != q.shape
            or do.shape != q.shape or m.shape != (bh, s)
            or l.shape != (bh, s)):
        raise ValueError("flash_attention_bwd: residual shapes do not match "
                         f"q{tuple(q.shape)}")
    if bhkv == 0 or bh % bhkv:
        raise ValueError(f"flash_attention_bwd: {bh} query rows are not a "
                         f"multiple of {bhkv} KV rows (GQA)")
    kv_len = s if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= s:
        raise ValueError(f"flash_attention_bwd: kv_len {kv_len} outside "
                         f"[0, {s}]")
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    grad_dtypes = (q.dtype, k.dtype, v.dtype) if grad_dtypes is None \
        else tuple(grad_dtypes)
    if not device.on_card(q):
        if counts:
            raise ValueError("flash_attention_bwd: counts come from the "
                             "CUDA kernels; the plain version runs no tiles")
        return ref.flash_bwd_ref(q, k, v, o, m, l, do, causal=causal,
                                 window=window, sm_scale=scale,
                                 kv_len=kv_len, grad_dtypes=grad_dtypes)
    do = do.contiguous()
    _check_bwd_cuda(q, k, v, o, m, l, do, grad_dtypes)
    if counts:
        return _bwd_kernels(q, k, v, o, m, l, do, causal, window, scale,
                            kv_len, grad_dtypes[0], counts=True)
    return _bwd_op(q, k, v, o, m, l, do, causal, window, scale, kv_len,
                   grad_dtypes[0])


def _bwd_kernels(q, k, v, o, m, l, do, causal, window, sm_scale, kv_len,
                 dtype, counts: bool = False):
    """The CUDA backward's three launches (delta, dQ, dKV) on inputs that
    :func:`flash_attention_bwd` has checked: ``repro_torch::flash_bwd``'s
    body, and with ``counts`` the kernels' counters too."""
    kw = dict(causal=causal, window=window, sm_scale=sm_scale, kv_len=kv_len,
              counts=counts)
    delta = _bwd_delta(o, do)
    dq, cnt_q = _bwd_dq(q, k, v, do, m, l, delta, dtype=dtype, **kw)
    dk, dv, cnt_k = _bwd_dkv(q, k, v, do, m, l, delta, dtype=dtype, **kw)
    return (dq, dk, dv, cnt_q, cnt_k) if counts else (dq, dk, dv)


# The three launches of the CUDA backward, on inputs that
# flash_attention_bwd has checked; separate so that each can be timed.
# dQ and dKV go to the kernels bwd_route names.
def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _bwd_delta(o, do):
    bh, s, d = o.shape
    delta = torch.empty((bh, s), dtype=torch.float32, device=o.device)
    BWD_DELTA(o.data_ptr(), do.data_ptr(), delta.data_ptr(), bh, s, d,
              _DTYPES[o.dtype], _DTYPES[do.dtype], _stream(o))
    return delta


def _route(q, do, dtype):
    return bwd_route(q.dtype, do.dtype, dtype, q.shape[-1])


def _bwd_args(q, k, do, dtype, causal, window, sm_scale, kv_len):
    bh, s, d = q.shape
    return (bh, k.shape[0], s, d, _DTYPES[q.dtype], _DTYPES[do.dtype],
            _DTYPES[dtype], int(bool(causal)), int(window), kv_len,
            sm_scale, _stream(q))


def _bwd_dq(q, k, v, do, m, l, delta, *, dtype, causal, window, sm_scale,
            kv_len, counts):
    bh, s, _ = q.shape
    dq = torch.empty(q.shape, dtype=dtype, device=q.device)
    cnt = torch.empty((bh, -(-s // BQ)), dtype=torch.int32,
                      device=q.device) if counts else None
    kern = BWD_DQ_SM90 if _route(q, do, dtype) == "sm90" else BWD_DQ
    kern(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
         m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(),
         None if cnt is None else cnt.data_ptr(),
         *_bwd_args(q, k, do, dtype, causal, window, sm_scale, kv_len))
    return dq, cnt


def _bwd_dkv(q, k, v, do, m, l, delta, *, dtype, causal, window, sm_scale,
             kv_len, counts):
    bhkv, s, _ = k.shape
    dk = torch.empty(k.shape, dtype=dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=dtype, device=k.device)
    cnt = torch.empty((bhkv, -(-s // BK)), dtype=torch.int32,
                      device=k.device) if counts else None
    kern = BWD_DKV_SM90 if _route(q, do, dtype) == "sm90" else BWD_DKV
    kern(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
         m.data_ptr(), l.data_ptr(), delta.data_ptr(), dk.data_ptr(),
         dv.data_ptr(), None if cnt is None else cnt.data_ptr(),
         *_bwd_args(q, k, do, dtype, causal, window, sm_scale, kv_len))
    return dk, dv, cnt


# :func:`flash_attention_fwd` as one operator to the dispatcher, as the
# Pallas call is one primitive to JAX: a selective-checkpoint policy
# (``core.checkpoint``) sees this op and not the plain version's products
# or the kernel's output buffers, so a recomputed segment runs the forward
# again, kernel launch included, under every policy.  Defined through
# ``torch.library.Library`` rather than ``custom_op``, whose Python
# wrapper costs several times the dispatch on every call (serve prefill
# runs one a layer); the op is only ever called inside ``_FlashFn``, so
# it needs no autograd formula of its own.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window, float sm_scale) -> (Tensor, Tensor, Tensor)")
_LIB.impl("flash_fwd",
          lambda q, k, v, causal, window, sm_scale: flash_attention_fwd(
              q, k, v, causal=causal, window=window, sm_scale=sm_scale),
          "CompositeExplicitAutograd")


@torch.library.register_fake("repro_torch::flash_fwd", lib=_LIB)
def _(q, k, v, causal, window, sm_scale):
    if device.card_trace_active():
        device.count_card_call(FWD_SM90 if _check_cuda(q, k, v) == "sm90"
                               else KERNEL)
    stats = q.new_empty(q.shape[:2], dtype=torch.float32)
    return torch.empty_like(q), stats, torch.empty_like(stats)


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _(q, k, v, causal, window, sm_scale, *, out_shape=None, **kw):
    return fwd_flops(q[0], q[1], q[2], causal=causal, window=window)


# The backward's three launches as one operator, as the forward: a fake
# for the dry run's trace, and a FLOP formula.  Called only from
# flash_attention_bwd, on checked inputs (dO contiguous, one gradient
# dtype).
_LIB.define("flash_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor m, "
            "Tensor l, Tensor do, bool causal, int window, float sm_scale, "
            "int kv_len, ScalarType grad_dtype) -> (Tensor, Tensor, Tensor)")
_LIB.impl("flash_bwd", _bwd_kernels, "CompositeExplicitAutograd")


@torch.library.register_fake("repro_torch::flash_bwd", lib=_LIB)
def _(q, k, v, o, m, l, do, causal, window, sm_scale, kv_len, grad_dtype):
    if device.card_trace_active():
        sm90 = _route(q, do, grad_dtype) == "sm90"
        for kern in (BWD_DELTA, BWD_DQ_SM90 if sm90 else BWD_DQ,
                     BWD_DKV_SM90 if sm90 else BWD_DKV):
            device.count_card_call(kern)
    return (q.new_empty(q.shape, dtype=grad_dtype),
            k.new_empty(k.shape, dtype=grad_dtype),
            v.new_empty(v.shape, dtype=grad_dtype))


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _(q, k, v, o, m, l, do, causal, window, sm_scale, kv_len, grad_dtype, *,
      out_shape=None, **kw):
    return bwd_flops(q[0], q[1], q[2], causal=causal, window=window,
                     kv_len=kv_len)


_fwd_op = torch.ops.repro_torch.flash_fwd.default
_bwd_op = torch.ops.repro_torch.flash_bwd.default


class _FlashFn(torch.autograd.Function):
    """Flat (BH, S, D) flash attention with the recompute backward.

    Saves (q, k, v, o) -- in ``resid_dtype`` when one is given -- and the
    f32 row stats (m, l); the backward writes the gradients in the primal
    dtypes of q, k, v straight from the kernels' f32 accumulators."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale, resid_dtype):
        o, m, l = _fwd_op(q, k, v, causal, window,
                          q.shape[-1] ** -0.5 if sm_scale is None
                          else float(sm_scale))
        saved = (q, k, v, o)
        if resid_dtype is not None:
            saved = tuple(x.to(resid_dtype) for x in saved)
        ctx.save_for_backward(*saved, m, l)
        ctx.opts = dict(causal=causal, window=window, sm_scale=sm_scale,
                        grad_dtypes=(q.dtype, k.dtype, v.dtype))
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, m, l, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    sm_scale: float | None = None, resid_dtype=None):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D) -> (B, H, S, D).

    Differentiable on both devices.  ``resid_dtype`` (e.g.
    ``torch.bfloat16``) stores the saved (q, k, v, o) in that dtype
    between forward and backward; (m, l) stay f32 and the gradients come
    back in the dtypes of q, k, v (``Policy.flash_resid_dtype``)."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if hkv == 0 or h % hkv:
        raise ValueError(
            f"flash_attention: n_heads={h} must be a non-zero multiple of "
            f"n_kv={hkv} (GQA) for q{tuple(q.shape)}, k{tuple(k.shape)}")
    if resid_dtype is not None and all(x.dtype == resid_dtype
                                       for x in (q, k, v)):
        resid_dtype = None                 # residuals already follow inputs
    # reshape of a (B, S, H, D) transpose is a strided view when B == 1
    o = _FlashFn.apply(
        q.reshape(b * h, s, d).contiguous(),
        k.reshape(b * hkv, s, d).contiguous(),
        v.reshape(b * hkv, s, d).contiguous(), causal, window, sm_scale,
        resid_dtype)
    return o.reshape(b, h, s, d)
