"""Public SSD op: the chunked scan of mamba2's sequence mixer (counterpart
of ``repro.kernels.ssd.ops``).

The FLOP-heavy intra-chunk part goes through ``ssd_chunk``, which
dispatches on the device: CPU tensors go to the plain
``ref.ssd_chunk_ref``; CUDA tensors go to the hand-written kernel
``kernels/csrc/ssd.cu`` or raise.  The inter-chunk state recurrence (T
steps over (N, P) states), its fold and the ``y_inter`` product stay in
PyTorch, as the JAX op keeps them out of its kernel.

The kernel has no backward (nor has the TPU kernel): on the card,
``ssd_chunk`` raises when autograd would need a gradient through it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import ref

MAX_CHUNK = 128
SUPPORTED_STATE = (16, 128)        # N
SUPPORTED_HEAD_P = (16, 64)        # P

KERNEL = build.Kernel("ssd", "ssd_chunk", [
    build.PTR, build.PTR, build.PTR, build.PTR, build.PTR, build.PTR,
    build.INT, build.INT, build.INT, build.INT, build.INT, build.INT,
    build.PTR])


def _check_cuda(c, b, xbar, acum):
    tensors = (c, b, xbar, acum)
    if not all(t.is_cuda and t.device == xbar.device for t in tensors):
        raise ValueError("ssd_chunk: operands must all be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("ssd_chunk: the CUDA kernel takes float32 operands")
    if any(t.requires_grad for t in tensors) and torch.is_grad_enabled():
        raise NotImplementedError(
            "ssd_chunk: the CUDA kernel has no backward; training the SSM "
            "family on the card comes with a later slice of the port")
    g, t, q, p = xbar.shape
    gc, _, _, n = c.shape
    if (c.shape[1:3] != (t, q) or b.shape != c.shape
            or acum.shape != (g, t, q) or gc < 1 or g % gc):
        raise ValueError(f"ssd_chunk: shapes do not match: c {tuple(c.shape)}"
                         f", b {tuple(b.shape)}, xbar {tuple(xbar.shape)}, "
                         f"acum {tuple(acum.shape)}")
    if not 1 <= q <= MAX_CHUNK or n not in SUPPORTED_STATE \
            or p not in SUPPORTED_HEAD_P:
        raise ValueError(f"ssd_chunk: the CUDA kernel takes chunk <= "
                         f"{MAX_CHUNK}, d_state in {SUPPORTED_STATE} and "
                         f"head_p in {SUPPORTED_HEAD_P}, got {q}, {n}, {p}")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
               for x in tensors):
        raise ValueError("ssd_chunk: operands must be contiguous and "
                         "16-byte aligned")


def ssd_chunk(c, b, xbar, acum):
    """Intra-chunk output and chunk-end states.

    xbar (G, T, Q, P), acum (G, T, Q), all f32.  c, b are (G, T, Q, N), or
    head-shared (G // H, T, Q, N): folded row g then reads c[g // H] (the
    kernel's way of taking mamba2's one B/C group without broadcasting it
    over the heads).  Returns (y_intra (G, T, Q, P), state (G, T, N, P))."""
    g, t, q, p = xbar.shape
    heads = g // c.shape[0]
    if not xbar.is_cuda:
        if heads > 1:
            c = c.repeat_interleave(heads, dim=0)
            b = b.repeat_interleave(heads, dim=0)
        return ref.ssd_chunk_ref(c, b, xbar, acum)
    _check_cuda(c, b, xbar, acum)
    n = c.shape[-1]
    y = torch.empty((g, t, q, p), dtype=torch.float32, device=xbar.device)
    state = torch.empty((g, t, n, p), dtype=torch.float32, device=xbar.device)
    KERNEL(c.data_ptr(), b.data_ptr(), xbar.data_ptr(), acum.data_ptr(),
           y.data_ptr(), state.data_ptr(), g, t, q, n, p, heads,
           torch.cuda.current_stream(xbar.device).cuda_stream)
    return y, state


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
    xbar = (x * dt[..., None]).to(f32)
    alog = (dt * a[None, None, :]).to(f32)                          # (B,L,H)
    acum = torch.cumsum(alog.reshape(bsz, t, chunk, h), dim=2)      # (B,T,Q,H)

    # fold (B, H) -> G rows; B and C stay (B, T, Q, N), shared by the heads
    c_f = c.reshape(bsz, t, chunk, n).to(f32).contiguous()
    b_f = b.reshape(bsz, t, chunk, n).to(f32).contiguous()
    x_f = xbar.reshape(bsz, t, chunk, h, p).permute(0, 3, 1, 2, 4).reshape(
        bsz * h, t, chunk, p).contiguous()
    a_f = acum.permute(0, 3, 1, 2).reshape(bsz * h, t, chunk).contiguous()
    y_intra, chunk_states = ssd_chunk(c_f, b_f, x_f, a_f)

    # inter-chunk state recurrence: S_{j+1} = exp(sum_j) S_j + state_j
    chunk_decay = torch.exp(a_f[:, :, -1])                          # (G, T)
    s = (torch.zeros((bsz * h, n, p), dtype=f32, device=x.device)
         if initial_state is None
         else initial_state.reshape(bsz * h, n, p).to(f32))
    s_in = []                                   # the state entering chunk j
    for j in range(t):
        s_in.append(s)
        s = s * chunk_decay[:, j, None, None] + chunk_states[:, j]
    s_in = torch.stack(s_in, 1).reshape(bsz, h, t, n, p)

    # exp(Acum_t) (C_t @ S): the JAX op scales C before the product; here
    # the (B, H, T, Q, P) product is scaled, so the head-shared C is never
    # broadcast over the heads (the same sum, rounded once more)
    y_inter = torch.einsum("btqn,bhtnp->bhtqp", c_f, s_in) * torch.exp(
        a_f).reshape(bsz, h, t, chunk)[..., None]
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
