"""GQA attention for prefill and cached decode, cross-attention, and MLA
(counterpart of ``repro.models.attention``).

Prefill and training go through the flash op (``kernels/flash``) where
the reference's ``attn_block`` takes its Pallas kernel: causal attention
over 1-D positions.  The op runs the CUDA kernels on the card and their
plain versions on the CPU; it is differentiable, so ``loss.backward()``
runs the flash backward.  Each layer gets its window as a Python int, so
windowed and global layers both reach the flash kernel.  Every other call
runs the plain :func:`gqa_attention`, as the reference runs its jnp path
there: whisper's bidirectional encoder (``causal=False``) and qwen2-vl's
M-RoPE prefill (positions (3, B, S)).  :func:`cross_attn_block`,
whisper's decoder attending over every encoder frame, is the reference's
plain f32 einsums.  Decode writes the new token into the cache in place
and reads the cache through ``kernels/kvq.decode_attention`` (quantized)
or the plain masked softmax (unquantized), masked by length for a
full-causal layer and for a rolling window buffer (the two-tier cache,
``transformer.decode_step_two_tier``), and by a dense (B, S) bias for a
window band over a full-length cache; under M-RoPE the decode position
turns all three streams, as in the reference.

MLA (minicpm3) is the reference's: :func:`mla_block` runs the plain
:func:`gqa_attention` (one-shot, or KV-chunked online softmax for long
prompts), as ``repro.models.attention.mla_block`` does -- no kernel lies on
MLA's path in the reference, so none lies on the port's -- and
:func:`mla_decode` attends in the latent space over a bf16 latent cache.

Over a mesh's model axis (``transformer.forward(mesh=)``, serving and
training) a layer holds this rank's block of its weights, and the head
counts come from the weights' shapes.  Heads mode: ``wq`` / ``wk`` /
``wv`` hold this rank's contiguous H / n query and Hkv / n KV heads
(whole GQA groups), the flash and decode kernels run unchanged on them,
and ``wo`` is row-parallel: its partial products are summed over the
model axis (``collectives.reduce_from_model``); in training the layer's
input enters through ``collectives.copy_to_model``, whose backward sums
the heads' partial input gradients.  Sequence mode (the heads do not
divide the axis): the projections are whole on every rank, the prefill
attends over the whole prompt, and :func:`attn_decode` (``kv_shard=
"seq"``) reads this rank's slice of the cache's sequence through
``collectives.sp_decode_attention_int8``.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.kvq import ops as kvq_ops
from repro_torch.kernels.kvq.ref import masked_decode_logits
from repro_torch.kernels.tiling import NEG_INF
from repro_torch.models.layers import apply_rope, rms_norm

CHUNKED_THRESHOLD = 4096   # S*S f32 scores above this use the chunked path
KV_CHUNK = 1024


def _mask_bias(q_pos, k_pos, window: int):
    """(..., Sq, Sk) f32 additive bias: causal plus an optional sliding
    window (``window`` <= 0: full causal)."""
    dist = q_pos[..., :, None] - k_pos[..., None, :]
    ok = dist >= 0
    if window > 0:
        ok = ok & (dist < window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def gqa_attention(q, k, v, *, q_pos, k_pos, window: int = 0,
                  causal: bool = True, sm_scale: float | None = None):
    """q: (B, Sq, H, D); k: (B, Sk, Hkv, D); v: (B, Sk, Hkv, Dv) ->
    (B, Sq, H, Dv) in q's dtype: the plain attention of
    ``repro.models.attention.gqa_attention``, in f32.

    One-shot softmax when ``Sq * Sk <= CHUNKED_THRESHOLD**2 // 4`` or
    ``Sk <= KV_CHUNK``; otherwise a KV-chunked online softmax over chunks
    of ``KV_CHUNK`` keys (the last zero-padded, its keys at position 2^30
    so the causal mask drops them), which keeps O(Sq x chunk) scores
    live.  Plain PyTorch on both devices: it is the reference's own path
    for MLA, which reaches no Pallas kernel."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = sm_scale if sm_scale is not None else d ** -0.5
    qf = q.reshape(b, sq, hkv, g, d).float()

    if sq * sk <= CHUNKED_THRESHOLD ** 2 // 4 or sk <= KV_CHUNK:
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
        if causal:
            logits = logits + _mask_bias(q_pos, k_pos, window)[:, None, None]
        pr = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", pr, v.float())
        return out.reshape(b, sq, h, dv).to(q.dtype)

    nchunk = -(-sk // KV_CHUNK)
    pad = nchunk * KV_CHUNK - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=2 ** 30)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    for c in range(nchunk):
        sl = slice(c * KV_CHUNK, (c + 1) * KV_CHUNK)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qf,
                              k[:, sl].float()) * scale
        if causal:
            logits = logits + _mask_bias(q_pos, k_pos[:, sl],
                                         window)[:, None, None]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(logits - m_new[..., None])
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", pr, v[:, sl].float())
        l = l * alpha + pr.sum(dim=-1)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]        # (B,Hkv,G,Sq,Dv)
    out = torch.movedim(out, 3, 1).reshape(b, sq, h, dv)
    return out.to(q.dtype)


def _row_parallel(out, wo, cfg, mesh):
    """``out @ wo``, summed over the model axis when ``wo`` holds only this
    rank's rows (heads mode; the sum's backward is the identity)."""
    y = out @ wo
    if wo.shape[0] != cfg.n_heads * cfg.head_dim:
        y = collectives.reduce_from_model(y, mesh)
    return y


def attn_block(p, x, cfg, *, positions, window: int = 0,
               causal: bool = True, resid_dtype=None, mesh=None):
    """x: (B, S, D_model); p holds wq/wk/wv/wo, cast to ``x.dtype`` here.
    ``positions``: (B, S), or (3, B, S) under M-RoPE.  Returns (out,
    (k, v)) with k, v (B, S, Hkv, hd) after RoPE.  The flash op takes the
    call where the reference's Pallas kernel does (``attention.py:122-124``:
    causal, 1-D positions); otherwise :func:`gqa_attention`, masked by the
    first stream's positions.  ``resid_dtype`` is the storage dtype of the
    flash op's saved (q, k, v, o) under autograd
    (``Policy.flash_resid_dtype``).  The head counts are the weights':
    this rank's heads on a mesh's model axis in heads mode (``wo``'s
    partial products then summed over ``mesh``'s model axis), all of them
    otherwise.  Under autograd in heads mode ``x`` enters through
    ``collectives.copy_to_model``, so its gradient is summed over the
    ranks' heads; in sequence mode every rank computes the whole
    attention and its whole input gradient."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h, hkv = p.wq.shape[1] // hd, p.wk.shape[1] // hd
    dt = x.dtype
    if h != cfg.n_heads:               # heads mode: column-parallel q/k/v
        x = collectives.copy_to_model(x, mesh)
    q = (x @ p.wq.to(dt)).reshape(b, s, h, hd)
    k = (x @ p.wk.to(dt)).reshape(b, s, hkv, hd)
    v = (x @ p.wv.to(dt)).reshape(b, s, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction,
                   cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction,
                   cfg.mrope_sections)
    if causal and positions.ndim < 3:
        out = flash_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=window, resid_dtype=resid_dtype)
        out = out.transpose(1, 2)
    else:
        pos1d = positions[0] if positions.ndim == 3 else positions
        out = gqa_attention(q, k, v, q_pos=pos1d, k_pos=pos1d, window=window,
                            causal=causal)
    return _row_parallel(out.reshape(b, s, h * hd), p.wo.to(dt), cfg,
                         mesh), (k, v)


def cross_attn_block(p, x, enc_kv, cfg, mesh=None):
    """Whisper's decoder cross-attention (``repro.models.attention``
    ``cross_attn_block``): x (B, S, D_model) attends over every encoder
    frame of ``enc_kv`` = (k, v), each (B, Se, Hkv, hd), projected from the
    encoder's output by the caller; no RoPE, no mask, f32 scores.  p holds
    wq / wo (its wk / wv are the caller's), cast to ``x.dtype`` here.  The
    head counts are the weights': this rank's heads in heads mode on
    ``mesh``'s model axis, ``wo``'s partial products then summed (the
    caller takes ``x`` through ``collectives.copy_to_model``)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h, hkv = p.wq.shape[1] // hd, enc_kv[0].shape[2]
    dt = x.dtype
    k, v = enc_kv
    qg = (x @ p.wq.to(dt)).reshape(b, s, hkv, h // hkv, hd).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * hd ** -0.5
    pr = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", pr, v.float())
    return _row_parallel(out.reshape(b, s, h * hd).to(dt), p.wo.to(dt), cfg,
                         mesh)


def _write_token(cache, new, at):
    """Write one token into the S axis of a per-layer cache leaf, IN PLACE.

    cache: (B, Hkv, S, hd) or (B, Hkv, S); new: (B, Hkv, hd) / (B, Hkv);
    at: 0-d int (every row writes the same slot) or (B,) int (each row at
    its own length).  The JAX version returns an updated copy; the port
    writes into the pool's buffer on purpose, so a decode step moves one
    token per row instead of copying the cache.  Indices clamp to the last
    slot, as ``dynamic_update_slice`` does."""
    s = cache.shape[2]
    at = at.clamp(0, s - 1)
    if at.ndim == 0:
        cache[:, :, at] = new.to(cache.dtype)
    else:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, :, at] = new.to(cache.dtype)
    return cache


def decode_mask(pos, b: int, s_max: int, window: int):
    """The decode mask of one layer over a non-rolling cache of ``s_max``
    slots: (lengths (B,) int32, None) for a full-causal layer (window <= 0),
    or (None, bias (B, S) f32) for a window band, which lengths cannot
    express: 0 where ``pos - window < slot <= pos``, -1e30 elsewhere (the
    JAX package's ``attention.py:334-352``)."""
    if window <= 0:
        return (pos + 1).to(torch.int32).expand(b).contiguous(), None
    kv_pos = torch.arange(s_max, device=pos.device)
    pos_col = pos[:, None] if pos.ndim == 1 else pos     # broadcasts vs (., S)
    valid = (kv_pos[None, :] <= pos_col) & (kv_pos[None, :] > pos_col - window)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    return None, bias.expand(b, s_max).contiguous()


def rolling_mask(pos, b: int, s_max: int):
    """The decode mask of a rolling buffer of ``s_max`` slots (the two-tier
    cache's window layers): (lengths = min(pos + 1, S) (B,) int32, None).
    Every filled slot is in the window by construction, so no bias."""
    return (torch.clamp(pos + 1, max=s_max).to(torch.int32).expand(b)
            .contiguous(), None)


def attn_decode(p, x_t, cfg, cache_k, cache_s_k, cache_v, cache_s_v, pos,
                *, window: int = 0, mask=None, quantized: bool = True,
                splits: int = 1, rolling: bool = False, mesh=None,
                kv_shard: str = "none"):
    """One-token GQA decode against a per-layer cache.

    x_t: (B, D_model); cache_k/v (B, Hkv, S, hd) int8 (or the compute dtype
    when not quantized, scales unused); pos: 0-d int32 position, or (B,)
    int32 per-row positions (slot-pooled serving: each row rotates, writes
    and masks at its own position).  ``window`` <= 0 masks by length,
    ``pos + 1``; a window > 0 masks by the dense bias of
    :func:`decode_mask`.  ``rolling``: the cache is a circular buffer of
    its S slots (a window layer of the two-tier cache): the token is
    written at ``pos % S`` and masked by :func:`rolling_mask`'s lengths.
    ``mask`` is that (lengths, bias) pair when the caller already built it
    for this window and position (a decode step builds one for all the
    layers that share a window).  The cache leaves are updated in place
    and returned.  ``kv_shard`` (``sharding.serve_kv_shard`` on ``mesh``)
    names the cache's layout on a mesh's model axis: "heads", this rank's
    KV heads (the weights hold the same heads; ``wo`` is row-parallel);
    "seq", this rank's slice of the sequence (S_l of the mask's S slots),
    read and written by ``collectives.sp_decode_attention_int8`` (a
    quantized, non-rolling cache only); "none", the whole cache.
    Returns (attn_out (B, D_model), (k, k_scale, v, v_scale))."""
    b, _ = x_t.shape
    hd = cfg.head_dim
    h, hkv = p.wq.shape[1] // hd, p.wk.shape[1] // hd
    seq = kv_shard == "seq"
    if seq and (rolling or not quantized):
        raise ValueError("attn_decode: a sequence-sharded cache is the "
                         "serve pool's int8 layout, never rolling")
    per_row = pos.ndim == 1
    q = (x_t @ p.wq).reshape(b, 1, h, hd)
    k_t = (x_t @ p.wk).reshape(b, 1, hkv, hd)
    v_t = (x_t @ p.wv).reshape(b, 1, hkv, hd)
    pos_arr = (pos[:, None] if per_row else pos).expand(b, 1)
    if cfg.mrope_sections is not None:       # the position on all 3 streams
        pos_arr = pos_arr.expand(3, b, 1)
    q = apply_rope(q, pos_arr, cfg.rope_theta, cfg.rope_fraction,
                   cfg.mrope_sections)[:, 0]
    k_new = apply_rope(k_t, pos_arr, cfg.rope_theta, cfg.rope_fraction,
                       cfg.mrope_sections)[:, 0]
    v_new = v_t[:, 0]
    s_max = cache_k.shape[2]
    if seq:
        s_max *= mesh.shape["model"]           # the whole sequence's slots
    if mask is None:
        mask = rolling_mask(pos, b, s_max) if rolling else decode_mask(
            pos, b, s_max, window)
    lengths, bias = mask
    at = pos % s_max if rolling else pos

    if seq:
        write = (*kvq_ops.quantize_kv(k_new), *kvq_ops.quantize_kv(v_new))
        out = collectives.sp_decode_attention_int8(
            q, cache_k, cache_s_k, cache_v, cache_s_v, write, at.expand(b),
            mesh, sm_scale=hd ** -0.5, lengths=lengths, bias=bias,
            splits=splits)[0]
    elif quantized:
        kq_new, ks_new = kvq_ops.quantize_kv(k_new)
        vq_new, vs_new = kvq_ops.quantize_kv(v_new)
        _write_token(cache_k, kq_new, at)
        _write_token(cache_v, vq_new, at)
        _write_token(cache_s_k, ks_new, at)
        _write_token(cache_s_v, vs_new, at)
        out = kvq_ops.decode_attention(q, cache_k, cache_s_k, cache_v,
                                       cache_s_v, lengths=lengths, bias=bias,
                                       splits=splits)
    else:
        _write_token(cache_k, k_new, at)
        _write_token(cache_v, v_new, at)
        qg = q.reshape(b, hkv, h // hkv, hd).float()
        logits = masked_decode_logits(qg, cache_k.float(), hd ** -0.5, bias,
                                      lengths)
        pr = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgs,bhsd->bhgd", pr,
                           cache_v.float()).reshape(b, h, hd)
    out = out.reshape(b, h * hd).to(x_t.dtype)
    return (_row_parallel(out, p.wo, cfg, mesh),
            (cache_k, cache_s_k, cache_v, cache_s_v))


# ---------------------------------------------------------------------------
# MLA (MiniCPM3 / DeepSeek-V2 style multi-head latent attention).
# ---------------------------------------------------------------------------
def mla_block(p, x, cfg, *, positions):
    """Latent-compressed attention (``repro.models.attention.mla_block``):
    x (B, S, D_model); p holds q_a, q_a_norm, q_b, kv_a, kv_a_norm, kv_b,
    wo, cast to ``x.dtype`` here.  The query and the keys' no-rope part
    come up from their latents (each ``rms_norm``-ed), RoPE turns only the
    ``qk_rope_dim`` part, the one rope key is shared by every head, and
    the scale is ``(qk_nope_dim + qk_rope_dim) ** -0.5``.  Returns
    (out, (kv_latent (B, S, kv_lora), k_rope (B, S, 1, dr)))."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim
    dt = x.dtype
    eps, bf = cfg.norm_eps, cfg.norm_bf16_grad

    q_lat = rms_norm(x @ p.q_a.to(dt), p.q_a_norm.to(dt), eps, bf16_grad=bf)
    q = (q_lat @ p.q_b.to(dt)).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]

    kv_all = x @ p.kv_a.to(dt)                          # (B, S, kv_lora + dr)
    kv_lat = rms_norm(kv_all[..., :m.kv_lora_rank], p.kv_a_norm.to(dt), eps,
                      bf16_grad=bf)
    k_rope = kv_all[..., m.kv_lora_rank:].reshape(b, s, 1, dr)
    kv = (kv_lat @ p.kv_b.to(dt)).reshape(b, s, h, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]

    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    out = gqa_attention(qf, kf, v, q_pos=positions, k_pos=positions,
                        sm_scale=(dn + dr) ** -0.5)
    return out.reshape(b, s, h * dv) @ p.wo.to(dt), (kv_lat, k_rope)


def mla_decode(p, x_t, cfg, cache_lat, cache_rope, pos):
    """One-token MLA decode with weight absorption
    (``repro.models.attention.mla_decode``), in the latent space:

      score = (q_nope @ Wk_b) . kv_lat + q_rope . k_rope
      out   = (softmax . kv_lat) @ Wv_b

    x_t: (B, D_model); cache_lat (B, S, kv_lora) and cache_rope (B, S, dr),
    bf16 under every policy; pos: 0-d int32 (lockstep: every row at one
    position).  The new token's latent and rope key are written into the
    caches IN PLACE at ``pos`` (the reference returns updated copies), and
    slots ``<= pos`` are attended.  Returns (out (B, D_model),
    (cache_lat, cache_rope))."""
    m = cfg.mla
    b = x_t.shape[0]
    h = cfg.n_heads
    dn, dr, dv = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim
    s_max = cache_lat.shape[1]
    eps, bf = cfg.norm_eps, cfg.norm_bf16_grad

    q_lat = rms_norm(x_t @ p.q_a, p.q_a_norm, eps, bf16_grad=bf)
    q = (q_lat @ p.q_b).reshape(b, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    pos_arr = pos.expand(b, 1)
    q_rope = apply_rope(q_rope[:, None], pos_arr, cfg.rope_theta)[:, 0]

    kv_all = x_t @ p.kv_a
    lat_new = rms_norm(kv_all[..., :m.kv_lora_rank], p.kv_a_norm, eps,
                       bf16_grad=bf)
    kr_new = apply_rope(kv_all[..., m.kv_lora_rank:][:, None, None],
                        pos_arr, cfg.rope_theta)[:, 0, 0]
    at = pos.clamp(0, s_max - 1)          # as dynamic_update_slice clamps
    cache_lat[:, at] = lat_new.to(cache_lat.dtype)
    cache_rope[:, at] = kr_new.to(cache_rope.dtype)

    kv_b = p.kv_b.reshape(m.kv_lora_rank, h, dn + dv)
    wk_b, wv_b = kv_b[..., :dn].float(), kv_b[..., dn:].float()
    q_abs = torch.einsum("bhd,lhd->bhl", q_nope.float(), wk_b)
    cl = cache_lat.float()
    scores = torch.einsum("bhl,bsl->bhs", q_abs, cl)
    scores = scores + torch.einsum("bhd,bsd->bhs", q_rope.float(),
                                   cache_rope.float())
    scores = scores * (dn + dr) ** -0.5
    valid = torch.arange(s_max, device=x_t.device)[None, :] <= pos
    scores = torch.where(valid[:, None], scores, NEG_INF)
    pr = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhs,bsl->bhl", pr, cl)
    out = torch.einsum("bhl,lhd->bhd", o_lat, wv_b)
    out = out.reshape(b, h * dv).to(x_t.dtype)
    return out @ p.wo, (cache_lat, cache_rope)
