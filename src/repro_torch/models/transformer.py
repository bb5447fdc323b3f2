"""The dense GQA decoder (counterpart of ``repro.models.transformer``).

The JAX package keeps per-layer parameters stacked along a layer axis and
scans over them; the port holds one ``Block`` module per layer in an
``nn.ModuleList`` and loops in Python (serving runs no remat).  Weights
keep the JAX ``x @ W`` orientation, ``(d_in, d_out)``, so
``models/bridge.py`` copies leaves without transposing.  A model is cast
to its policy's compute dtype once, when it is built or loaded
(:meth:`Transformer.cast_to_compute`), not at every call.

Public entry points:
  init_params(cfg, seed, ...)          -> Transformer
  forward(model, cfg, batch, ...)      -> (logits (B, S, V), aux)
  init_cache(cfg, batch, s_max, ...)   -> decode cache dict
  decode_step(model, cfg, cache, ...)  -> (logits (B, V), cache)
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.mixed_precision import Policy
from repro_torch.kernels.kvq import ops as kvq_ops
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, embed_init, rms_norm, swiglu

#: cache leaves with a sequence axis, and which axis it is
CACHE_SEQ_AXES = {"k": 3, "v": 3, "k_scale": 3, "v_scale": 3}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not build yet."""
    unsupported = [name for name, present in (
        ("MoE", cfg.moe is not None), ("MLA", cfg.mla is not None),
        ("SSM", cfg.ssm is not None or cfg.mixer != "attn"),
        ("encoder", cfg.encoder is not None),
        ("M-RoPE", cfg.mrope_sections is not None),
        ("sliding window", cfg.window > 0 or bool(cfg.global_layers)),
        ("gelu MLP", cfg.mlp_kind != "swiglu"),
        ("vision patches", cfg.family == "vlm")) if present]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.arch_id}: {', '.join(unsupported)} not ported yet (the "
            f"port builds the dense GQA decoder; other families come with "
            f"slice F)")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    # serving never differentiates; the training slice turns grads on
    return nn.Parameter(t, requires_grad=False)


class Attention(nn.Module):
    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_frozen, (wq, wk, wv, wo))


class SwiGLU(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = map(_frozen,
                                                  (w_gate, w_up, w_down))


class Block(nn.Module):
    def __init__(self, ln1, ln2, attn_mod: Attention, ffn: SwiGLU):
        super().__init__()
        self.ln1, self.ln2 = _frozen(ln1), _frozen(ln2)
        self.attn = attn_mod
        self.ffn = ffn


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, embed, blocks, final_norm,
                 lm_head=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _frozen(final_norm)
        self.lm_head = None if lm_head is None else _frozen(lm_head)

    @property
    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def cast_to_compute(self, policy: Policy) -> "Transformer":
        """Cast every weight to the policy's compute dtype, once."""
        return self.to(dtype=policy.compute_dtype)


# ---------------------------------------------------------------------------
# Initialization.
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                dtype=torch.float32) -> Transformer:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``,
    straight in ``dtype`` on ``device`` (no host copy of a full-size model).
    Same distributions as the JAX init; not the same numbers."""
    check_supported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    ones = lambda n: torch.ones(n, **kw)  # noqa: E731
    blocks = []
    for _ in range(cfg.n_layers):
        blocks.append(Block(
            ones(d), ones(d),
            Attention(dense_init(gen, (d, h * hd), **kw),
                      dense_init(gen, (d, hkv * hd), **kw),
                      dense_init(gen, (d, hkv * hd), **kw),
                      dense_init(gen, (h * hd, d), **kw)),
            SwiGLU(dense_init(gen, (d, cfg.d_ff), **kw),
                   dense_init(gen, (d, cfg.d_ff), **kw),
                   dense_init(gen, (cfg.d_ff, d), **kw))))
    embed = embed_init(gen, (cfg.padded_vocab, d), **kw)
    lm_head = None if cfg.tie_embeddings else \
        dense_init(gen, (d, cfg.padded_vocab), **kw)
    return Transformer(cfg, embed, blocks, ones(d), lm_head)


def _mask_padded_vocab(logits, cfg: ModelConfig):
    """-1e30 the dead padded-vocab tail."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    dead = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab
    return logits.masked_fill(dead, -1e30)


# ---------------------------------------------------------------------------
# Forward (prefill).
# ---------------------------------------------------------------------------
def _kv_entry(k, v, *, quantized: bool = True) -> dict:
    """Per-layer prefill cache entry: k, v (B, S, Hkv, hd) -> cache axis
    order (B, Hkv, S, hd), int8 + f32 scales (bf16 + zero scales when not
    quantized, as in the JAX package)."""
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if quantized:
        kq, ks = kvq_ops.quantize_kv(k)
        vq, vs = kvq_ops.quantize_kv(v)
    else:
        kq, vq = k.to(torch.bfloat16), v.to(torch.bfloat16)
        ks = torch.zeros(k.shape[:-1], dtype=torch.float32, device=k.device)
        vs = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
    return {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}


def _assemble_cache(entries: list, s: int) -> dict:
    """Per-layer prefill entries -> the ``init_cache`` layout, pos = S."""
    cache = {name: torch.stack([e[name] for e in entries])
             for name in CACHE_SEQ_AXES}
    cache["pos"] = torch.tensor(s, dtype=torch.int32,
                                device=entries[0]["k"].device)
    return cache


def forward(model: Transformer, cfg: ModelConfig, batch: dict, *,
            policy: Policy = Policy.full(), build_cache: bool = False,
            cache_quantized: bool = True):
    """batch: {tokens (B, S)[, positions (B, S)]}.

    Returns (logits (B, S, V) in ``policy.output_dtype``, aux).  With
    ``build_cache`` aux["cache"] is a decode cache positioned at S in the
    ``init_cache`` layout."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = model.embed[tokens]                                 # (B, S, D)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    entries = []
    for blk in model.blocks:
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        mix, (k, v) = attn.attn_block(blk.attn, h, cfg, positions=positions,
                                      window=cfg.window)
        if build_cache:
            entries.append(_kv_entry(k, v, quantized=cache_quantized))
        x = x + mix
        h2 = rms_norm(x, blk.ln2, cfg.norm_eps)
        x = x + swiglu(h2, blk.ffn.w_gate, blk.ffn.w_up, blk.ffn.w_down)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    aux = {"moe_aux": 0.0}
    if build_cache:
        aux["cache"] = _assemble_cache(entries, s)
    logits = _mask_padded_vocab((x @ model.head).to(policy.output_dtype), cfg)
    return logits, aux


# ---------------------------------------------------------------------------
# KV cache and single-token decode.
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, s_max: int, *,
               quantized: bool = True, dtype=torch.bfloat16,
               device="cuda") -> dict:
    """(L, B, Hkv, S, hd) int8 K/V (``dtype`` when not quantized) plus
    (L, B, Hkv, S) f32 scales and a 0-d ``pos``."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, cfg.n_kv, s_max, cfg.head_dim)
    kv_dtype = torch.int8 if quantized else dtype
    z = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)  # noqa
    return {"pos": z((), torch.int32),
            "k": z(shape, kv_dtype), "v": z(shape, kv_dtype),
            "k_scale": z(shape[:-1], torch.float32),
            "v_scale": z(shape[:-1], torch.float32)}


def grow_cache(cache: dict, s_max: int) -> dict:
    """Zero-pad every sequence-bearing cache leaf out to ``s_max`` slots."""
    out = dict(cache)
    for name, ax in CACHE_SEQ_AXES.items():
        if name not in cache:
            continue
        x = cache[name]
        pad = s_max - x.shape[ax]
        if pad < 0:
            raise ValueError(f"grow_cache: {name} already has "
                             f"{x.shape[ax]} > {s_max} slots")
        if pad:
            shape = list(x.shape)
            shape[ax] = s_max
            grown = torch.zeros(shape, dtype=x.dtype, device=x.device)
            grown.narrow(ax, 0, x.shape[ax]).copy_(x)
            out[name] = grown
    return out


def decode_step(model: Transformer, cfg: ModelConfig, cache: dict, tokens_t,
                *, policy: Policy = Policy.full(), quantized: bool = True,
                kvq_splits: int = 1, active=None):
    """tokens_t: (B,) int current token.  Returns (logits (B, V), cache).

    The cache's K/V leaves are updated in place; the returned dict holds
    the same buffers and the advanced ``pos``.  With a per-row (B,) ``pos``
    (slot-pooled serving) every row decodes at its own position, and
    ``active`` ((B,) bool) gates the position increment so free slots stay
    frozen; their lengths stay >= 1 and their logits are never read."""
    pos = cache["pos"]
    per_slot = pos.ndim == 1
    if active is not None and not per_slot:
        raise ValueError("decode_step: active mask requires a per-slot "
                         "(vector) cache['pos']")
    x = model.embed[tokens_t]                               # (B, D)
    for i, blk in enumerate(model.blocks):
        h = rms_norm(x[:, None], blk.ln1, cfg.norm_eps)[:, 0]
        mix, _ = attn.attn_decode(
            blk.attn, h, cfg, cache["k"][i], cache["k_scale"][i],
            cache["v"][i], cache["v_scale"][i], pos, quantized=quantized,
            splits=kvq_splits)
        x = x + mix
        h2 = rms_norm(x[:, None], blk.ln2, cfg.norm_eps)
        x = x + swiglu(h2, blk.ffn.w_gate, blk.ffn.w_up, blk.ffn.w_down)[:, 0]
    x = rms_norm(x[:, None], model.final_norm, cfg.norm_eps)[:, 0]
    logits = _mask_padded_vocab((x @ model.head).to(policy.output_dtype), cfg)
    new_cache = dict(cache)
    new_cache["pos"] = pos + (active.to(torch.int32) if active is not None
                              else 1)
    return logits, new_cache
