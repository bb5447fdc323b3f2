"""Public SSD op: the chunked scan of mamba2's sequence mixer (counterpart
of ``repro.kernels.ssd.ops``).

The FLOP-heavy intra-chunk part goes through ``ssd_chunk``, one operator
to the dispatcher (``repro_torch::ssd_chunk``) inside a differentiable
``torch.autograd.Function``, each direction dispatched on the device:

* forward: CPU tensors go to the plain ``ref.ssd_chunk_ref``; CUDA tensors
  go to a hand-written kernel chosen by shape (:func:`ssd_route`): head_p
  64 (mamba2's and hymba's widths) to ``kernels/csrc/ssd_sm90.cu`` (3xTF32
  wgmma, the scores shared by a CTA's group of heads), head_p 16 to
  ``ssd.cu`` (f32 FMA);
* backward: CPU tensors go to the plain ``ref.ssd_chunk_bwd_ref`` (the
  explicit formulas, head sum included); CUDA tensors to a hand-written
  kernel chosen by shape (:func:`ssd_bwd_route`): head_p 64 to
  ``kernels/csrc/ssd_bwd_sm90.cu`` (3xTF32 wgmma, the scores once a
  (batch, chunk), dc / db from the head-summed dS), head_p 16 to
  ``ssd_bwd.cu`` (f32 FMA).  Both recompute the scores and the decay from
  the saved (c, b, xbar, acum) and sum dc / db over the heads in a fixed
  order.

No route falls back to another: a shape no kernel takes raises, and so does
a kernel that fails to build or launch.  The inter-chunk state recurrence
(T steps over (N, P) states), its fold and the ``y_inter`` product stay in
PyTorch under autograd, as the JAX op keeps them out of its kernel.

Both directions are operators to the dispatcher (``repro_torch::ssd_chunk``,
``repro_torch::ssd_chunk_bwd``), each with a fake that gives the kernel's
outputs and a FLOP formula that counts the chunk's products
(:func:`chunk_flops`, :func:`chunk_bwd_flops`).  Inside
``core.device.trace_for_card`` fake tensors take the card's route to those
fakes.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core import device
from repro_torch.kernels import build
from repro_torch.kernels.ssd import ref

MAX_CHUNK = 128
SUPPORTED_STATE = (16, 128)        # N
SUPPORTED_HEAD_P = (16, 64)        # P

SM90_HEAD_P = 64                   # P the tensor-core kernel takes

KERNEL = build.Kernel("ssd", "ssd_chunk", [
    build.PTR, build.PTR, build.PTR, build.PTR, build.PTR, build.PTR,
    build.INT, build.INT, build.INT, build.INT, build.INT, build.INT,
    build.PTR])
KERNEL_SM90 = build.Kernel("ssd_sm90", "ssd_chunk_sm90",
                           KERNEL.argtypes[:-1] + [build.INT, build.PTR])
KERNEL_BWD = build.Kernel("ssd_bwd", "ssd_chunk_bwd",
                          [build.PTR] * 10 + [build.INT] * 6 + [build.PTR])
KERNEL_BWD_SM90 = build.Kernel("ssd_bwd_sm90", "ssd_chunk_bwd_sm90",
                               KERNEL_BWD.argtypes)


def ssd_route(n: int, p: int) -> str:
    """Which hand-written kernel takes a CUDA chunk of d_state ``n`` and
    head_p ``p``: ``"sm90"`` (``ssd_sm90.cu``, 3xTF32 on the tensor cores)
    at head_p 64, whose wgmma tiles are 64 wide; ``"fma"`` (``ssd.cu``, f32
    FMA, which takes head_p 16 only) at head_p 16, the smoke
    configurations' width, which neither of the tensor-core kernel's forms
    fits.  Raises for anything neither takes."""
    if n not in SUPPORTED_STATE or p not in SUPPORTED_HEAD_P:
        raise ValueError(f"ssd_chunk: the CUDA kernels take d_state in "
                         f"{SUPPORTED_STATE} and head_p in "
                         f"{SUPPORTED_HEAD_P}, got {n}, {p}")
    return "sm90" if p == SM90_HEAD_P else "fma"


def ssd_bwd_route(n: int, p: int) -> str:
    """Which hand-written kernel takes the gradient of a CUDA chunk of
    d_state ``n`` and head_p ``p``: ``"sm90"`` (``ssd_bwd_sm90.cu``, 3xTF32
    on the tensor cores) at head_p 64, ``"fma"`` (``ssd_bwd.cu``, f32 FMA,
    head_p 16 only) at head_p 16, as :func:`ssd_route` splits the forward.
    Raises for anything neither takes."""
    return ssd_route(n, p)


def heads_per_cta(pairs: int, heads: int, sms: int) -> int:
    """Heads one CTA of ``ssd_sm90.cu`` walks, computing the scores C B^T
    once for all of them: the fewest groups of heads whose grid of
    ``pairs`` (batch, chunk) pairs x groups still gives every one of the
    ``sms`` SMs a CTA (one CTA an SM fits).  mamba2's and hymba's serve
    shapes (128 pairs) take all their heads in one CTA; a one-chunk prompt
    of 8 rows takes two heads a CTA."""
    groups = max(1, min(heads, sms // pairs))
    return -(-heads // groups)


def _check_cuda(c, b, xbar, acum, *grads) -> str:
    """Check a CUDA chunk's operands (and the backward's incoming dy,
    dstate); return :func:`ssd_route`'s route (the backward's
    :func:`ssd_bwd_route` is the same)."""
    tensors = (c, b, xbar, acum, *grads)
    if not device.on_one_card(*tensors):
        raise ValueError("ssd_chunk: operands must all be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("ssd_chunk: the CUDA kernel takes float32 operands")
    g, t, q, p = xbar.shape
    gc, _, _, n = c.shape
    if (c.shape[1:3] != (t, q) or b.shape != c.shape
            or acum.shape != (g, t, q) or gc < 1 or g % gc):
        raise ValueError(f"ssd_chunk: shapes do not match: c {tuple(c.shape)}"
                         f", b {tuple(b.shape)}, xbar {tuple(xbar.shape)}, "
                         f"acum {tuple(acum.shape)}")
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"ssd_chunk: the CUDA kernels take chunk <= "
                         f"{MAX_CHUNK}, got {q}")
    route = ssd_route(n, p)
    if grads and (grads[0].shape != xbar.shape
                  or grads[1].shape != (g, t, n, p)):
        raise ValueError(f"ssd_chunk: gradients do not match: dy "
                         f"{tuple(grads[0].shape)}, dstate "
                         f"{tuple(grads[1].shape)}")
    if not all(x.is_contiguous() and not device.misaligned(x)
               for x in tensors):
        raise ValueError("ssd_chunk: operands must be contiguous and "
                         "16-byte aligned")
    return route


def _chunk_fwd(c, b, xbar, acum):
    """The operator's body: :func:`ssd_chunk` without autograd.  The sm90
    route's CTAs walk :func:`heads_per_cta`'s group of heads."""
    g, t, q, p = xbar.shape
    heads = g // c.shape[0]
    if not device.on_card(xbar):
        if heads > 1:
            c = c.repeat_interleave(heads, dim=0)
            b = b.repeat_interleave(heads, dim=0)
        return ref.ssd_chunk_ref(c, b, xbar, acum)
    route = _check_cuda(c, b, xbar, acum)
    n = c.shape[-1]
    dev = xbar.device
    y = torch.empty((g, t, q, p), dtype=torch.float32, device=dev)
    state = torch.empty((g, t, n, p), dtype=torch.float32, device=dev)
    args = (c.data_ptr(), b.data_ptr(), xbar.data_ptr(), acum.data_ptr(),
            y.data_ptr(), state.data_ptr(), g, t, q, n, p, heads)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "fma":
        KERNEL(*args, stream)
    else:
        group = heads_per_cta(g // heads * t, heads, torch.cuda
                              .get_device_properties(dev)
                              .multi_processor_count)
        KERNEL_SM90(*args, group, stream)
    return y, state


def ssd_chunk_bwd(c, b, xbar, acum, dy, dstate):
    """The gradient of :func:`ssd_chunk` -> (dc, db, dxbar, dacum), all f32.

    Operands as :func:`ssd_chunk`'s, c and b head-shared (G // H, T, Q, N);
    dy (G, T, Q, P) and dstate (G, T, N, P) the incoming gradients.  dc and
    db come back summed over the H heads that share them.  CPU tensors take
    ``ref.ssd_chunk_bwd_ref``; CUDA tensors the kernel of
    :func:`ssd_bwd_route`: ``ssd_bwd_sm90.cu`` at head_p 64,
    ``ssd_bwd.cu`` at head_p 16."""
    if not device.on_card(xbar):
        return ref.ssd_chunk_bwd_ref(c, b, xbar, acum, dy, dstate)
    _check_cuda(c, b, xbar, acum, dy, dstate)
    return _bwd_op(c, b, xbar, acum, dy, dstate)


def _chunk_bwd(c, b, xbar, acum, dy, dstate):
    """``repro_torch::ssd_chunk_bwd``'s body: one launch of the kernel of
    :func:`ssd_bwd_route` on operands :func:`ssd_chunk_bwd` has checked."""
    g, t, q, p = xbar.shape
    n = c.shape[-1]
    dc, db = torch.empty_like(c), torch.empty_like(b)
    dx, da = torch.empty_like(xbar), torch.empty_like(acum)
    kernel = KERNEL_BWD_SM90 if ssd_bwd_route(n, p) == "sm90" else KERNEL_BWD
    kernel(*(z.data_ptr() for z in (c, b, xbar, acum, dy, dstate, dx, da, dc,
                                    db)),
           g, t, q, n, p, g // c.shape[0],
           torch.cuda.current_stream(xbar.device).cuda_stream)
    return dc, db, dx, da


# The chunk as one operator to the dispatcher, as the Pallas call is one
# primitive to JAX: a selective-checkpoint policy (``core.checkpoint``
# ``SavePolicy``) sees this op and not the plain version's products, so a
# recomputed segment runs the forward again, kernel launch included, and
# on ``device="meta"`` the fake gives the shapes.  Defined through
# ``torch.library.Library`` as ``repro_torch::flash_fwd`` is
# (``kernels/flash/ops.py``); only ever called inside ``_SSDChunkFn``.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_chunk(Tensor c, Tensor b, Tensor xbar, Tensor acum) -> "
            "(Tensor, Tensor)")
_LIB.impl("ssd_chunk", _chunk_fwd, "CompositeExplicitAutograd")


@torch.library.register_fake("repro_torch::ssd_chunk", lib=_LIB)
def _(c, b, xbar, acum):
    if device.card_trace_active():
        device.count_card_call(KERNEL_SM90 if _check_cuda(c, b, xbar, acum)
                               == "sm90" else KERNEL)
    g, t, q, p = xbar.shape
    return (xbar.new_empty((g, t, q, p)),
            xbar.new_empty((g, t, c.shape[-1], p)))


def chunk_flops(g: int, t: int, q: int, n: int, p: int) -> int:
    """The chunk's products for ``g`` folded rows of ``t`` chunks of
    ``q``: the scores C B^T (2 Q^2 N), y_intra = (scores o decay) xbar
    (2 Q^2 P) and the chunk-end state B^T (w o xbar) (2 Q N P), a row and
    chunk; the scores counted for every row (head), as the plain version
    computes them."""
    return g * t * (2 * q * q * n + 2 * q * q * p + 2 * q * n * p)


def chunk_bwd_flops(g: int, t: int, q: int, n: int, p: int) -> int:
    """The chunk backward's products, a row and chunk: the scores
    recomputed (2 Q^2 N), dxbar from dy and from dstate (2 Q^2 P + 2 Q N
    P), d(scores) = dy xbar^T (2 Q^2 P), dc and db from it (4 Q^2 N), db's
    term from dstate (2 Q N P)."""
    return g * t * (6 * q * q * n + 4 * q * q * p + 4 * q * n * p)


@register_flop_formula(torch.ops.repro_torch.ssd_chunk)
def _(c, b, xbar, acum, *, out_shape=None, **kw):
    g, t, q, p = xbar
    return chunk_flops(g, t, q, c[-1], p)


# The backward's launch as one operator too, with a fake and a FLOP
# formula; called only from ssd_chunk_bwd, on checked operands.
_LIB.define("ssd_chunk_bwd(Tensor c, Tensor b, Tensor xbar, Tensor acum, "
            "Tensor dy, Tensor dstate) -> (Tensor, Tensor, Tensor, Tensor)")
_LIB.impl("ssd_chunk_bwd", _chunk_bwd, "CompositeExplicitAutograd")


@torch.library.register_fake("repro_torch::ssd_chunk_bwd", lib=_LIB)
def _(c, b, xbar, acum, dy, dstate):
    if device.card_trace_active():
        device.count_card_call(
            KERNEL_BWD_SM90 if ssd_bwd_route(c.shape[-1], xbar.shape[-1])
            == "sm90" else KERNEL_BWD)
    return (torch.empty_like(c), torch.empty_like(b),
            torch.empty_like(xbar), torch.empty_like(acum))


@register_flop_formula(torch.ops.repro_torch.ssd_chunk_bwd)
def _(c, b, xbar, acum, dy, dstate, *, out_shape=None, **kw):
    g, t, q, p = xbar
    return chunk_bwd_flops(g, t, q, c[-1], p)


_chunk_op = torch.ops.repro_torch.ssd_chunk.default
_bwd_op = torch.ops.repro_torch.ssd_chunk_bwd.default


class _SSDChunkFn(torch.autograd.Function):
    """The chunk with its hand-written backward: saves (c, b, xbar, acum)
    and recomputes the rest (no (Q, Q) tensor is kept)."""

    @staticmethod
    def forward(ctx, c, b, xbar, acum):
        ctx.save_for_backward(c, b, xbar, acum)
        return _chunk_op(c, b, xbar, acum)

    @staticmethod
    def backward(ctx, dy, dstate):
        return ssd_chunk_bwd(*ctx.saved_tensors, dy.contiguous(),
                             dstate.contiguous())


def ssd_chunk(c, b, xbar, acum):
    """Intra-chunk output and chunk-end states, differentiable.

    xbar (G, T, Q, P), acum (G, T, Q), all f32.  c, b are (G, T, Q, N), or
    head-shared (G // H, T, Q, N): folded row g then reads c[g // H] (the
    kernels' way of taking mamba2's one B/C group without broadcasting it
    over the heads).  Returns (y_intra (G, T, Q, P), state (G, T, N, P));
    the backward is :func:`ssd_chunk_bwd`."""
    return _SSDChunkFn.apply(c, b, xbar, acum)


def _part(name: str):
    """A profiler range over one part of :func:`ssd` (the folds and casts
    in, the chunk kernel, the recurrence, y_inter, the sum, skip and cast
    out), opened only while a profiler records: the op's device time by
    part, read by chip_smoke.py's serve_ssm profile."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


def ssd(x, dt, a, b, c, d, *, chunk: int = 128, initial_state=None,
        return_state: bool = False):
    """Chunked SSD.

    x: (B, L, H, P); dt: (B, L, H) (>= 0); a: (H,) negative log-decay
    rates; b, c: (B, L, N) (one group, shared by the heads); d: (H,) skip.
    L % chunk == 0.  Returns y (B, L, H, P) in ``x.dtype`` [, final_state
    (B, H, N, P) f32]."""
    bsz, L, h, p = x.shape
    n = b.shape[-1]
    if L % chunk:
        raise ValueError(f"ssd: sequence length {L} is not a multiple of "
                         f"the chunk {chunk}")
    t = L // chunk
    f32 = torch.float32                  # state recurrences in f32
    with _part("ssd.fold"):
        xbar = (x * dt[..., None]).to(f32)
        alog = (dt * a[None, None, :]).to(f32)                      # (B,L,H)
        acum = torch.cumsum(alog.reshape(bsz, t, chunk, h), dim=2)  # (B,T,Q,H)
        # fold (B, H) -> G rows; B and C stay (B, T, Q, N), head-shared
        c_f = c.reshape(bsz, t, chunk, n).to(f32).contiguous()
        b_f = b.reshape(bsz, t, chunk, n).to(f32).contiguous()
        x_f = xbar.reshape(bsz, t, chunk, h, p).permute(0, 3, 1, 2, 4) \
            .reshape(bsz * h, t, chunk, p).contiguous()
        a_f = acum.permute(0, 3, 1, 2).reshape(bsz * h, t, chunk).contiguous()
    with _part("ssd.chunk"):
        y_intra, chunk_states = ssd_chunk(c_f, b_f, x_f, a_f)

    # inter-chunk state recurrence: S_{j+1} = exp(sum_j) S_j + state_j
    with _part("ssd.recurrence"):
        chunk_decay = torch.exp(a_f[:, :, -1])                      # (G, T)
        s = (torch.zeros((bsz * h, n, p), dtype=f32, device=x.device)
             if initial_state is None
             else initial_state.reshape(bsz * h, n, p).to(f32))
        s_in = []                               # the state entering chunk j
        for j in range(t):
            s_in.append(s)
            s = s * chunk_decay[:, j, None, None] + chunk_states[:, j]
        s_in = torch.stack(s_in, 1).reshape(bsz, h, t, n, p)

    # exp(Acum_t) (C_t @ S): the JAX op scales C before the product; here
    # the (B, H, T, Q, P) product is scaled, so the head-shared C is never
    # broadcast over the heads (the same sum, rounded once more)
    with _part("ssd.y_inter"):
        y_inter = torch.einsum("btqn,bhtnp->bhtqp", c_f, s_in) * torch.exp(
            a_f).reshape(bsz, h, t, chunk)[..., None]
    with _part("ssd.out"):
        y = (y_intra.reshape(bsz, h, t, chunk, p) + y_inter)
        y = y.permute(0, 2, 3, 1, 4).reshape(bsz, L, h, p)
        y = y + x.to(f32) * d[None, None, :, None]
        y = y.to(x.dtype)
    if return_state:
        return y, s.reshape(bsz, h, n, p)
    return y


def ssd_decode_step(state, x_t, dt_t, a, b_t, c_t, d):
    """Single-token recurrent step for serving.

    state: (B, H, N, P); x_t: (B, H, P); dt_t: (B, H); b_t, c_t: (B, N).
    Returns (new_state, y_t (B, H, P))."""
    da = torch.exp(dt_t * a[None, :])[..., None, None]              # (B,H,1,1)
    xbar = x_t * dt_t[..., None]
    state = state * da + torch.einsum("bn,bhp->bhnp", b_t, xbar)
    y = torch.einsum("bn,bhnp->bhp", c_t, state) + x_t * d[None, :, None]
    return state, y
