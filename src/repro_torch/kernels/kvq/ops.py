"""Public op: GQA decode attention over an int8 KV cache (counterpart of
``repro.kernels.kvq.ops``).

``decode_attention`` takes the deployed layout -- query heads flat, cache
pre-quantized -- and dispatches on the device: CPU tensors go to the
plain ``ref.decode_attention_ref``; CUDA tensors go to the hand-written
split-K kernel ``kernels/csrc/flash_decode.cu`` or raise.  ``lengths``
masks by position on both, and on the card it also keeps every KV tile
past a row's length from being loaded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, tiling
from repro_torch.kernels.kvq import ref
from repro_torch.kernels.kvq.ref import (combine_splits,  # noqa: F401
                                         quantize_kv)

SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_GROUPS = (1, 2, 4, 8)
MAX_BLOCK_S = 512

KERNEL = build.Kernel("flash_decode", "flash_decode", [
    build.PTR, build.PTR, build.PTR, build.PTR, build.PTR, build.PTR,
    build.PTR, build.PTR, build.PTR, build.PTR, build.INT, build.INT,
    build.INT, build.INT, build.INT, build.INT, build.INT, build.INT,
    build.INT, build.FLOAT, build.PTR])


def resolve_splits(s: int, splits: int,
                   block_s: int = tiling.DEFAULT_DECODE_BS) -> int:
    """The split count the kernel actually runs for a length-S cache."""
    return tiling.resolve_decode_grid(s, block_s=block_s, splits=splits)[2]


def _check_cuda(qg, k_q, k_s, v_q, v_s, lengths, block_s):
    tensors = (qg, k_q, k_s, v_q, v_s, lengths)
    if not all(t.is_cuda and t.device == qg.device for t in tensors):
        raise ValueError("decode_attention: q, cache and lengths must all be "
                         "on one CUDA device")
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise TypeError(f"decode_attention: the CUDA kernel takes an int8 "
                        f"cache, got {k_q.dtype}, {v_q.dtype}")
    if k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise TypeError("decode_attention: cache scales must be float32")
    if lengths.dtype != torch.int32:
        raise TypeError("decode_attention: lengths must be int32")
    b, hkv, g, d = qg.shape
    s = k_q.shape[2]
    if d not in SUPPORTED_HEAD_DIMS or g not in SUPPORTED_GROUPS:
        raise ValueError(f"decode_attention: the CUDA kernel takes head_dim "
                         f"in {SUPPORTED_HEAD_DIMS} and GQA group in "
                         f"{SUPPORTED_GROUPS}, got {d}, {g}")
    if (k_s.shape != (b, hkv, s) or v_q.shape != k_q.shape
            or v_s.shape != k_s.shape or lengths.shape != (b,)):
        raise ValueError("decode_attention: cache / scales / lengths shapes "
                         "do not match")
    if block_s > MAX_BLOCK_S:
        raise ValueError(f"decode_attention: block_s {block_s} > "
                         f"{MAX_BLOCK_S}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: operands must be contiguous")
    if k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
        raise ValueError("decode_attention: int8 cache must be 16-byte "
                         "aligned")


def decode_attention(q, k_q, k_s, v_q, v_s, *, lengths=None, bias=None,
                     sm_scale: float | None = None, splits: int = 1,
                     block_s: int | None = None, counts: bool = False):
    """q: (B, H, D); cache (B, Hkv, S, D) int8 with (B, Hkv, S) f32 scales.

    ``lengths`` (B,) int32: valid cache lengths.  ``bias`` (B, S) f32 is
    the dense mask of the plain version only (the kernel's bias operand
    comes with windowed models).  ``splits`` fans the KV axis over the
    kernel's split-K grid.  Returns (B, H, D) f32, plus with ``counts``
    (CUDA only) the (B, Hkv, splits) tiles each split executed -- the
    measured twin of ``tiling.decode_tile_step_counts``."""
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
    if not q.is_cuda:
        if counts:
            raise ValueError("decode_attention: counts come from the CUDA "
                             "kernel; the plain version runs no tiles")
        out = ref.decode_attention_ref(qg, k_q, k_s, v_q, v_s, bias, sm,
                                       lengths=lengths)
        return out.reshape(b, h, d)
    if bias is not None:
        raise NotImplementedError("decode_attention: the CUDA kernel has no "
                                  "dense bias operand yet (windowed models)")
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    block_s = tiling.DEFAULT_DECODE_BS if block_s is None else block_s
    qg = qg.contiguous()
    _check_cuda(qg, k_q, k_s, v_q, v_s, lengths, block_s)
    bs, ns, n_sp, spt = tiling.resolve_decode_grid(s, block_s=block_s,
                                                   splits=splits)
    dev = q.device
    if n_sp == 1:
        out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=dev)
        m_p = l_p = None
    else:
        out = torch.empty((b, hkv, n_sp, g, d), dtype=torch.float32,
                          device=dev)
        m_p = torch.empty((b, hkv, n_sp, g), dtype=torch.float32, device=dev)
        l_p = torch.empty_like(m_p)
    cnt = (torch.empty((b, hkv, n_sp), dtype=torch.int32, device=dev)
           if counts else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    KERNEL(qg.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
           v_s.data_ptr(), lengths.data_ptr(), out.data_ptr(), ptr(m_p),
           ptr(l_p), ptr(cnt), b, hkv, g, s, d, bs, ns, spt, n_sp, sm,
           torch.cuda.current_stream(dev).cuda_stream)
    if n_sp > 1:
        out = combine_splits(out, m_p, l_p, torch.float32)
    out = out.reshape(b, h, d)
    return (out, cnt) if counts else out
