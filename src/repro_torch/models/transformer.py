"""The decoder stack (counterpart of ``repro.models.transformer``): dense
GQA (llama3, glm4, stablelm), dense MLA (minicpm3: latent attention,
``attention.mla_block``, with a latent cache), MoE (deepseek-moe,
granite-moe: GQA attention, then ``models/moe.py``'s routed experts in
place of the SwiGLU), pure SSM
(mamba2: SSD blocks, no MLP) and hybrid (hymba: attention and SSM heads
in parallel, each output normed, the two averaged, then a SwiGLU), with
per-layer sliding windows and global layers; encoder-decoder (whisper: a
bidirectional encoder over stub frame embeddings, then decoder layers
with a cross-attention after the self-attention and a GELU MLP) and VLM
(qwen2-vl: M-RoPE over (3, B, S) positions, stub patch embeddings
projected into the prompt's prefix, the head tied to the embedding).

The JAX package keeps per-layer parameters stacked along a layer axis and
scans over them; the port holds one ``Block`` module per layer in an
``nn.ModuleList`` and loops in Python, under ``core.checkpoint.remat_scan``
when training.  Weights keep the JAX ``x @ W`` orientation,
``(d_in, d_out)``, so ``models/bridge.py`` copies leaves without
transposing.

Two precision modes share one forward.  Serving casts a model to its
policy's compute dtype once, when it is built or loaded
(:meth:`Transformer.cast_to_compute`).  Training keeps f32 master weights
with ``requires_grad`` on (``model.requires_grad_()``), and the forward
casts each weight to ``policy.compute_dtype`` where it is used -- an
autograd op, so the gradients reach the masters in f32.  For a model
already in the compute dtype that cast is a no-op.

The encoder runs once a forward, outside the decoder's ``remat_scan``
(sequential checkpointing segments the decoder stack only, as in the
reference); each decoder layer projects its cross-attention K / V from the
encoder's output, in the forward and again at every decode step
(``enc_out``), as the reference does.

Serving over a mesh's model axis (``mesh=``, a ``launch/mesh.py`` ``Mesh``
whose model axis is > 1, the ranks joined in a process group): each rank
holds its block of the weights (:func:`init_params` / ``bridge``
``load_jax_params`` with ``mesh=``, placed by :func:`param_shard_specs`)
and of the cache (:func:`init_cache`).  The embedding is vocab-parallel (a
masked lookup of this rank's rows, summed over the axis), the SwiGLU's
``w_gate`` / ``w_up`` column-parallel and ``w_down`` row-parallel (one
sum), attention by heads or by the cache's sequence
(``attention.py``), and the head's vocab-sharded logits are gathered
whole (:func:`head_logits`), so every rank holds the same logits before
any host decision.  The MoE holds its block of the experts, TP-experts
or expert-parallel (``models/moe.py``), and sums its partials likewise.
The SSM mixer runs whole on every rank (its input and its output's
gradient are whole there: no collective), hymba's attention beside it
split as any GQA layer's, and its conv and SSM state are whole too.  The
encoder-decoder's encoder layers split as the decoder's, and each
decoder layer's cross-attention by heads (or whole in sequence mode),
over the encoder's output, whole on every rank.  MLA splits ``q_b`` /
``kv_b`` by heads and ``wo``'s rows likewise (the down-projections, both
latent norms and the rope key whole on every rank; the block whole where
the heads do not divide the axis), and its latent cache by sequence
(``attention.mla_decode``).  The two-tier cache places each tier by KV
heads, else by sequence (:func:`init_cache_two_tier`).

Training over the model axis runs the same forward under autograd: the
row-parallel sums are ``collectives.reduce_from_model`` (backward: the
identity), and the replicated input of every column-parallel product
(the FFN's, the attention's in heads mode, the final norm's output before
the vocab-sharded head) enters through ``collectives.copy_to_model``,
whose backward sums the ranks' partial gradients.  :func:`loss_fn`
(``mesh=``) never gathers the vocab: :func:`vocab_parallel_ce` reduces
the softmax's statistics over the axis, and its backward needs no
collective.

Public entry points:
  init_params(cfg, seed, ...)          -> Transformer
  forward(model, cfg, batch, ...)      -> (logits (B, S, V), aux)
  run_encoder(model, cfg, frames, ...) -> encoder output (B, Se, D)
  loss_fn(model, cfg, batch, ...)      -> (loss, aux)
  init_cache(cfg, batch, s_max, ...)   -> decode cache dict
  decode_step(model, cfg, cache, ...)  -> (logits (B, V), cache)
  init_cache_two_tier / decode_step_two_tier: the windowed archs' cache,
  full-length for the global layers, a rolling window for the others
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.checkpoint import (CheckpointConfig, checkpoint_name,
                                         remat_scan)
from repro_torch.core.mixed_precision import Policy
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.kvq import ops as kvq_ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, embed_init, gelu_mlp,
                                      rms_norm, swiglu)

#: cache leaves with a sequence axis, and which axis it is (the SSM's
#: ``conv`` and ``ssm`` state have none)
CACHE_SEQ_AXES = {"k": 3, "v": 3, "k_scale": 3, "v_scale": 3,
                  "mla_lat": 2, "mla_rope": 2}


def layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer window as Python ints: 0 = full causal (every layer of an
    unwindowed model, and ``cfg.global_layers``), else the sliding
    window."""
    glob = set(cfg.global_layers)
    return [0 if i in glob else cfg.window for i in range(cfg.n_layers)]


def _frozen(t: torch.Tensor) -> nn.Parameter:
    # serving never differentiates; training turns gradients on with
    # ``model.requires_grad_()``
    return nn.Parameter(t, requires_grad=False)


class Attention(nn.Module):
    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_frozen, (wq, wk, wv, wo))


class MLA(nn.Module):
    """Latent attention's weights (``attention.mla_block``), in the JAX
    layout: ``q_a`` (D, q_lora), ``q_a_norm`` (q_lora,), ``q_b`` (q_lora,
    H (dn + dr)), ``kv_a`` (D, kv_lora + dr), ``kv_a_norm`` (kv_lora,),
    ``kv_b`` (kv_lora, H (dn + dv)), ``wo`` (H dv, D)."""

    NAMES = ("q_a", "q_a_norm", "q_b", "kv_a", "kv_a_norm", "kv_b", "wo")

    def __init__(self, *weights):
        super().__init__()
        for name, w in zip(self.NAMES, weights, strict=True):
            setattr(self, name, _frozen(w))


class SwiGLU(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = map(_frozen,
                                                  (w_gate, w_up, w_down))


class GeluMLP(nn.Module):
    """Whisper's MLP (``layers.gelu_mlp``): ``w1`` (D, F), ``b1`` (F,),
    ``w2`` (F, D), ``b2`` (D,)."""

    NAMES = ("w1", "b1", "w2", "b2")

    def __init__(self, *weights):
        super().__init__()
        for name, w in zip(self.NAMES, weights, strict=True):
            setattr(self, name, _frozen(w))


class MoE(nn.Module):
    """Routed experts (``models/moe.py``): ``router`` (D, E), ``w_gate`` /
    ``w_up`` (E, D, F), ``w_down`` (E, F, D), and the shared experts'
    ``shared_gate`` / ``shared_up`` / ``shared_down`` when there are
    any."""

    NAMES = ("router", "w_gate", "w_up", "w_down")
    SHARED = ("shared_gate", "shared_up", "shared_down")

    def __init__(self, *weights):
        super().__init__()
        self.names = (self.NAMES + self.SHARED)[:len(weights)]
        for name, w in zip(self.names, weights, strict=True):
            setattr(self, name, _frozen(w))

    def weights(self, dtype=None) -> dict:
        return {n: getattr(self, n) if dtype is None
                else getattr(self, n).to(dtype) for n in self.names}


def ffn_apply(ffn, h, cfg, dtype=None, mesh=None):
    """The block's MLP on ``h`` (..., D) -> (out, aux): the SwiGLU or the
    GELU MLP (aux 0.0), or the MoE (``moe.moe_ffn`` over a (B, S, D)
    view), its weights cast to ``dtype`` where they are used.  A SwiGLU
    holding this rank's columns of ``w_gate`` / ``w_up`` and rows of
    ``w_down`` (the GELU MLP: of ``w1`` / ``b1`` and of ``w2``) takes its
    input through ``collectives.copy_to_model`` and sums its output over
    ``mesh``'s model axis, the GELU MLP adding its whole ``b2`` once,
    after the sum; the MoE holding its block of the experts does the same
    inside ``moe.moe_ffn``."""
    if isinstance(ffn, MoE):
        return moe_mod.moe_ffn(ffn.weights(dtype), h, cfg, mesh=mesh)
    cast = (lambda w: w) if dtype is None else (lambda w: w.to(dtype))
    if isinstance(ffn, GeluMLP):
        w1, b1, w2, b2 = (cast(getattr(ffn, n)) for n in GeluMLP.NAMES)
        if w2.shape[0] == cfg.d_ff:
            return gelu_mlp(h, w1, b1, w2, b2), 0.0
        # this rank's columns of w1 / b1 and rows of w2: b2 once, after
        # the row-parallel sum
        out = gelu_mlp(collectives.copy_to_model(h, mesh), w1, b1, w2, None)
        return collectives.reduce_from_model(out, mesh) + b2, 0.0
    parallel = ffn.w_down.shape[0] != cfg.d_ff      # this rank's columns
    if parallel:
        h = collectives.copy_to_model(h, mesh)
    out = swiglu(h, cast(ffn.w_gate), cast(ffn.w_up), cast(ffn.w_down))
    if parallel:                                     # row-parallel w_down
        out = collectives.reduce_from_model(out, mesh)
    return out, 0.0


class SSM(nn.Module):
    """Mamba2 mixer weights (``models/ssm.py``)."""

    NAMES = ("in_proj", "conv_w", "dt_bias", "a_log", "d_skip", "norm_w",
             "out_proj")

    def __init__(self, *weights):
        super().__init__()
        for name, w in zip(self.NAMES, weights, strict=True):
            setattr(self, name, _frozen(w))


class Block(nn.Module):
    """One layer: ``attn`` and/or ``ssm`` mixers (both: the hybrid, whose
    outputs are normed by ``mix_norm_attn`` / ``mix_norm_ssm`` and
    averaged), then, in an encoder-decoder, ``xattn`` over the encoder's
    output under ``ln_x``, then ``ffn`` when the model has one.  Every
    layer keeps ``ln2``, as the JAX tree does, even without an MLP."""

    def __init__(self, ln1, ln2, attn_mod: Attention | MLA | None = None,
                 ffn: SwiGLU | GeluMLP | MoE | None = None, *,
                 ssm: SSM | None = None, mix_norm_attn=None,
                 mix_norm_ssm=None, xattn: Attention | None = None,
                 ln_x=None):
        super().__init__()
        self.ln1, self.ln2 = _frozen(ln1), _frozen(ln2)
        self.attn = attn_mod
        self.ssm = ssm
        self.ffn = ffn
        self.mix_norm_attn = None if mix_norm_attn is None \
            else _frozen(mix_norm_attn)
        self.mix_norm_ssm = None if mix_norm_ssm is None \
            else _frozen(mix_norm_ssm)
        self.xattn = xattn
        self.ln_x = None if ln_x is None else _frozen(ln_x)


class EncBlock(nn.Module):
    """One encoder layer: ``ln1``, bidirectional ``attn``, ``ln2``, the
    ``ffn`` (whisper's GELU MLP)."""

    def __init__(self, ln1, ln2, attn_mod: Attention,
                 ffn: SwiGLU | GeluMLP):
        super().__init__()
        self.ln1, self.ln2 = _frozen(ln1), _frozen(ln2)
        self.attn = attn_mod
        self.ffn = ffn


class Transformer(nn.Module):
    """The decoder (``embed``, ``blocks``, ``final_norm``, ``lm_head``
    unless tied), and, where the arch has them, the encoder
    (``enc_blocks``, ``enc_norm``) and the patch projection
    (``patch_proj``)."""

    def __init__(self, cfg: ModelConfig, embed, blocks, final_norm,
                 lm_head=None, *, enc_blocks=None, enc_norm=None,
                 patch_proj=None):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _frozen(final_norm)
        self.lm_head = None if lm_head is None else _frozen(lm_head)
        self.enc_blocks = None if enc_blocks is None \
            else nn.ModuleList(enc_blocks)
        self.enc_norm = None if enc_norm is None else _frozen(enc_norm)
        self.patch_proj = None if patch_proj is None else _frozen(patch_proj)

    @property
    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def cast_to_compute(self, policy: Policy) -> "Transformer":
        """Cast every weight to the policy's compute dtype, once."""
        return self.to(dtype=policy.compute_dtype)


# ---------------------------------------------------------------------------
# Initialization, and each rank's block on a mesh.
# ---------------------------------------------------------------------------
def _model_n(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get("model", 1)


def check_mesh(cfg: ModelConfig, mesh) -> None:
    """Raise unless ``cfg`` runs over ``mesh``'s model axis.  Every arch
    does -- the GQA attention archs, MLA, the SSM mixers (whole on every
    rank) and the encoder-decoder -- and the MoE where each of its split
    dims divides the axis (the reference's ``shard_map`` takes no other;
    a ValueError naming the leaf)."""
    if _model_n(mesh) > 1:
        check_moe_split(cfg, mesh)


def check_moe_split(cfg: ModelConfig, mesh) -> None:
    """Raise (ValueError, naming the leaf) where an MoE leaf's split dim
    does not divide ``mesh``'s model axis: every expert leaf's F
    (TP-experts) or E (expert parallelism), the shared experts' Fs, as
    ``sharding.param_specs`` places them (the router is replicated);
    nothing for a dense arch or without a model axis."""
    n = _model_n(mesh)
    if cfg.moe is None or n == 1:
        return
    m = cfg.moe
    split = ("E", m.num_experts) if m.expert_mode == "ep" \
        else ("F", m.d_expert)
    dims = dict.fromkeys(("w_gate", "w_up", "w_down"), split)
    if m.num_shared:
        dims.update(dict.fromkeys(("shared_gate", "shared_up",
                                   "shared_down"), ("Fs", m.d_shared)))
    for leaf, (dim, size) in dims.items():
        if size % n:
            raise ValueError(
                f"{cfg.arch_id}: the MoE leaf ffn.{leaf} splits its {dim} "
                f"of {size} over the model axis, and {n} does not divide "
                f"it (expert_mode={cfg.moe.expert_mode!r})")


def param_shard_specs(cfg: ModelConfig, shapes, mesh) -> dict:
    """``{name: spec}`` of this slice's parameter placement on ``mesh``:
    ``sharding.param_specs`` (a dim that does not divide stays whole), with
    the attention projections whole where the heads do not divide the
    model axis (``sharding.flash_shard_specs`` splits no heads): sequence
    mode, where each rank attends over the whole prompt and its slice of
    the cache.  The cross-attention's projections (``xattn``) follow the
    self-attention's, the encoder's too.  MLA's heads are its query
    heads (its ``n_kv`` names no leaf): ``q_b`` / ``kv_b`` split by head
    and ``wo`` by its rows where ``n_heads`` divides the axis, else the
    block whole, where the reference would cut a head's columns.  The
    reference leaves that layout to XLA
    (``repro/models/attention.py:111-116``).  Every SSM leaf is whole
    (``sharding.param_specs``)."""
    specs = shd.param_specs(cfg, shapes, mesh)
    split = shd.flash_shard_specs(mesh, 1, cfg.n_heads,
                                  cfg.n_heads if cfg.mla else cfg.n_kv)
    if split is None or split[1] is None:
        for name in specs:
            parts = name.split(".")
            if len(parts) > 1 and parts[-2] in ("attn", "xattn"):
                specs[name] = ()
    return specs


def param_placement(cfg: ModelConfig, mesh) -> dict | None:
    """``{name: spec}``: where each parameter (and its AdamW moments) lies
    on ``mesh`` -- :func:`param_shard_specs` over the global shapes -- or
    None without a model axis > 1 (every rank holds the whole model)."""
    if _model_n(mesh) == 1:
        return None
    shapes = {n: tuple(p.shape) for n, p in init_params(
        cfg, device="meta").named_parameters()}
    return param_shard_specs(cfg, shapes, mesh)


def shard_fn(cfg: ModelConfig, mesh, rank: int | None = None):
    """``cut(name, leaf) -> this rank's block of the leaf`` under
    :func:`param_shard_specs` (``rank`` defaults to this process's);
    the identity without a model axis."""
    if _model_n(mesh) == 1:
        return lambda name, x: x
    check_moe_split(cfg, mesh)
    where = mesh_mod.coords(mesh, rank)

    def cut(name, x):
        spec = param_shard_specs(cfg, {name: tuple(x.shape)}, mesh)[name]
        return shd.shard_leaf(x, spec, mesh, where)
    return cut


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                dtype=torch.float32, mesh=None,
                rank: int | None = None) -> Transformer:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``,
    straight in ``dtype`` on ``device`` (no host copy of a full-size model).
    Same distributions as the JAX init; not the same numbers.  On
    ``device="meta"`` only the shapes and dtypes exist (the planner counts
    them).

    With ``mesh`` (a model axis > 1) the model is this rank's block
    (``rank`` defaults to this process's): every leaf is drawn whole, in
    the meshless order, and cut at once (:func:`shard_fn`), so the blocks
    equal the same slices of the meshless model from the same seed, and a
    full-width model is never whole in memory."""
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    cut = shard_fn(cfg, mesh, rank)

    def dense(name, shape, in_axis: int = 0):
        return cut(name, dense_init(gen, shape, in_axis=in_axis, **kw))

    def ones(name, n):
        return cut(name, torch.ones(n, **kw))

    def zeros(name, n):
        return cut(name, torch.zeros(n, **kw))

    def attention(pre):
        return Attention(dense(f"{pre}.wq", (d, h * hd)),
                         dense(f"{pre}.wk", (d, hkv * hd)),
                         dense(f"{pre}.wv", (d, hkv * hd)),
                         dense(f"{pre}.wo", (h * hd, d)))

    def dense_ffn(pre):           # the biases start at zero, as in JAX
        if cfg.mlp_kind == "gelu":
            return GeluMLP(dense(f"{pre}.w1", (d, cfg.d_ff)),
                           zeros(f"{pre}.b1", cfg.d_ff),
                           dense(f"{pre}.w2", (cfg.d_ff, d)),
                           zeros(f"{pre}.b2", d))
        return SwiGLU(dense(f"{pre}.w_gate", (d, cfg.d_ff)),
                      dense(f"{pre}.w_up", (d, cfg.d_ff)),
                      dense(f"{pre}.w_down", (cfg.d_ff, d)))

    blocks = []
    for i in range(cfg.n_layers):
        pre = f"blocks.{i}"
        mix = {}
        if cfg.mla is not None:
            m = cfg.mla
            a = f"{pre}.attn"
            mix["attn_mod"] = MLA(
                dense(f"{a}.q_a", (d, m.q_lora_rank)),
                ones(f"{a}.q_a_norm", m.q_lora_rank),
                dense(f"{a}.q_b", (m.q_lora_rank,
                                   h * (m.qk_nope_dim + m.qk_rope_dim))),
                dense(f"{a}.kv_a", (d, m.kv_lora_rank + m.qk_rope_dim)),
                ones(f"{a}.kv_a_norm", m.kv_lora_rank),
                dense(f"{a}.kv_b", (m.kv_lora_rank,
                                    h * (m.qk_nope_dim + m.v_head_dim))),
                dense(f"{a}.wo", (h * m.v_head_dim, d)))
        elif cfg.mixer in ("attn", "hybrid"):
            mix["attn_mod"] = attention(f"{pre}.attn")
        if cfg.mixer in ("ssm", "hybrid"):
            s = cfg.ssm
            a = f"{pre}.ssm"
            mix["ssm"] = SSM(
                dense(f"{a}.in_proj",
                      (d, 2 * s.d_inner + 2 * s.d_state + s.heads)),
                dense(f"{a}.conv_w",
                      (s.conv_kernel, s.d_inner + 2 * s.d_state)),
                zeros(f"{a}.dt_bias", s.heads),
                zeros(f"{a}.a_log", s.heads),          # A = -exp(0)
                ones(f"{a}.d_skip", s.heads), ones(f"{a}.norm_w", s.d_inner),
                dense(f"{a}.out_proj", (s.d_inner, d)))
        if cfg.mixer == "hybrid":
            mix.update(mix_norm_attn=ones(f"{pre}.mix_norm_attn", d),
                       mix_norm_ssm=ones(f"{pre}.mix_norm_ssm", d))
        if cfg.moe is not None:
            m = cfg.moe
            e, f = m.num_experts, m.d_expert
            a = f"{pre}.ffn"
            experts = [dense(f"{a}.router", (d, e)),
                       dense(f"{a}.w_gate", (e, d, f), in_axis=1),
                       dense(f"{a}.w_up", (e, d, f), in_axis=1),
                       dense(f"{a}.w_down", (e, f, d), in_axis=1)]
            if m.num_shared:
                experts += [dense(f"{a}.shared_gate", (d, m.d_shared)),
                            dense(f"{a}.shared_up", (d, m.d_shared)),
                            dense(f"{a}.shared_down", (m.d_shared, d))]
            mix["ffn"] = MoE(*experts)
        elif cfg.d_ff:
            mix["ffn"] = dense_ffn(f"{pre}.ffn")
        if cfg.encoder is not None:           # the decoder's cross-attention
            mix.update(xattn=attention(f"{pre}.xattn"),
                       ln_x=ones(f"{pre}.ln_x", d))
        blocks.append(Block(ones(f"{pre}.ln1", d), ones(f"{pre}.ln2", d),
                            **mix))
    embed = cut("embed", embed_init(gen, (cfg.padded_vocab, d), **kw))
    lm_head = None if cfg.tie_embeddings else \
        dense("lm_head", (d, cfg.padded_vocab))
    extra = {}
    if cfg.encoder is not None:
        extra.update(enc_blocks=[
            EncBlock(ones(f"enc_blocks.{i}.ln1", d),
                     ones(f"enc_blocks.{i}.ln2", d),
                     attention(f"enc_blocks.{i}.attn"),
                     dense_ffn(f"enc_blocks.{i}.ffn"))
            for i in range(cfg.encoder.n_layers)],
            enc_norm=ones("enc_norm", d))
    if cfg.family == "vlm":
        extra["patch_proj"] = dense("patch_proj", (d, d))
    return Transformer(cfg, embed, blocks, ones("final_norm", d), lm_head,
                       **extra)


def _mask_padded_vocab(logits, cfg: ModelConfig, offset: int = 0):
    """-1e30 the dead padded-vocab tail; ``logits`` may be a block of the
    vocab starting at global index ``offset``."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    dead = torch.arange(offset, offset + logits.shape[-1],
                        device=logits.device) >= cfg.vocab
    return logits.masked_fill(dead, -1e30)


def _embed(model: Transformer, cfg: ModelConfig, tokens, mesh=None):
    """The embedding rows of ``tokens``; vocab-parallel when ``embed``
    holds this rank's block of rows: each rank looks up the tokens in its
    block (zeros elsewhere) and the rows are summed over the model axis
    (exact: one non-zero term)."""
    e = model.embed
    if e.shape[0] == cfg.padded_vocab:
        return e[tokens]
    _, _, r = collectives.model_axis(mesh)
    v_l = e.shape[0]
    local = tokens.long() - r * v_l
    mine = (local >= 0) & (local < v_l)
    x = e[local.clamp(0, v_l - 1)]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return collectives.reduce_from_model(x, mesh)


def head_logits(model: Transformer, cfg: ModelConfig, x, policy: Policy,
                mesh=None):
    """x (..., D) in the compute dtype -> logits (..., V) in
    ``policy.output_dtype``, the padded tail masked.  A head holding this
    rank's block of the vocab masks its block by global index and the
    blocks are gathered whole (the same logits on every rank)."""
    head = model.head.to(x.dtype)
    logits = (x @ head).to(policy.output_dtype)
    if head.shape[-1] == cfg.padded_vocab:
        return _mask_padded_vocab(logits, cfg)
    _, _, r = collectives.model_axis(mesh)
    logits = _mask_padded_vocab(logits, cfg, offset=r * head.shape[-1])
    return collectives.model_all_gather(logits, mesh)


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


def _assemble_cache(entries: list, s: int, device) -> dict:
    """Per-layer prefill entries -> the ``init_cache`` layout, pos = S.  The
    MLA latents and the conv tail are kept in bf16 and the SSM state in
    f32 under every policy, as the JAX package stores them
    (``transformer.py:404-409``)."""
    cache = {name: torch.stack([e[name] for e in entries])
             for name in entries[0]}
    for name in ("mla_lat", "mla_rope"):
        if name in cache:
            cache[name] = cache[name].to(torch.bfloat16)
    if "ssm" in cache:
        cache["ssm"] = cache["ssm"].float()
        cache["conv"] = cache["conv"].to(torch.bfloat16)
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=device)
    return cache


def _mix(blk, cfg, a_out, s_out):
    """Combine the mixers' outputs: one of them as it is, or the hybrid's
    ``0.5 * (rms_norm(a) + rms_norm(s))``."""
    if s_out is None:
        return a_out
    if a_out is None:
        return s_out
    dt = a_out.dtype
    return 0.5 * (rms_norm(a_out, blk.mix_norm_attn.to(dt), cfg.norm_eps,
                           bf16_grad=cfg.norm_bf16_grad)
                  + rms_norm(s_out, blk.mix_norm_ssm.to(dt), cfg.norm_eps,
                             bf16_grad=cfg.norm_bf16_grad))


def run_encoder(model: Transformer, cfg: ModelConfig, frames,
                policy: Policy = Policy.full(), mesh=None):
    """Whisper's encoder over stub frame embeddings (B, Se, D) -> (B, Se,
    D) in the compute dtype (``repro.models.transformer._run_encoder``):
    a plain loop over ``enc_blocks`` -- bidirectional attention (the plain
    ``gqa_attention``, as the reference's jnp path) with RoPE at positions
    0..Se-1, then the MLP -- and ``enc_norm``.  Never under remat.  With
    ``mesh`` (a model axis > 1) the layers are this rank's blocks, split
    as the decoder's (the attention by heads, or whole in sequence mode;
    the MLP by columns and rows), and the output is whole on every
    rank."""
    dt = policy.compute_dtype
    eps, bf = cfg.norm_eps, cfg.norm_bf16_grad
    with moe_mod._part("encdec.encoder"):
        x = frames.to(dt)
        b, se, _ = x.shape
        pos = torch.arange(se, device=x.device).expand(b, se)
        for blk in model.enc_blocks:
            h = rms_norm(x, blk.ln1.to(dt), eps, bf16_grad=bf)
            x = x + attn.attn_block(blk.attn, h, cfg, positions=pos,
                                    causal=False, mesh=mesh)[0]
            h2 = rms_norm(x, blk.ln2.to(dt), eps, bf16_grad=bf)
            x = x + ffn_apply(blk.ffn, h2, cfg, dt, mesh=mesh)[0]
        return rms_norm(x, model.enc_norm.to(dt), eps, bf16_grad=bf)


def _cross_attend(blk, cfg, hx, enc_out, mesh=None):
    """The layer's cross-attention over the encoder's output: K / V
    projected from ``enc_out`` (cast to ``hx.dtype``) with the layer's
    ``xattn`` weights, then ``attention.cross_attn_block``.  ``xattn``
    holding this rank's KV heads (heads mode on ``mesh``'s model axis):
    ``hx`` and ``enc_out``, whole on every rank, enter through
    ``collectives.copy_to_model`` (their gradients are the ranks' heads'
    partials), and ``wo``'s partial products are summed."""
    dt = hx.dtype
    hd = cfg.head_dim
    hkv = blk.xattn.wk.shape[1] // hd
    with moe_mod._part("encdec.cross_attn"):
        if hkv != cfg.n_kv:
            hx = collectives.copy_to_model(hx, mesh)
            enc_out = collectives.copy_to_model(enc_out, mesh)
        e = enc_out.to(dt)
        b, se, _ = e.shape
        k = (e @ blk.xattn.wk.to(dt)).reshape(b, se, hkv, hd)
        v = (e @ blk.xattn.wv.to(dt)).reshape(b, se, hkv, hd)
        return attn.cross_attn_block(blk.xattn, hx, (k, v), cfg, mesh=mesh)


def forward(model: Transformer, cfg: ModelConfig, batch: dict, *,
            policy: Policy = Policy.full(),
            remat: CheckpointConfig = CheckpointConfig(),
            build_cache: bool = False, cache_quantized: bool = True,
            return_hidden: bool = False, mesh=None):
    """batch: {tokens (B, S)[, positions (B, S), or (3, B, S) under
    M-RoPE][, frames (B, Se, D) for an encoder][, patches (B, Sp, D) for
    a VLM]}.

    The patches, projected by ``patch_proj``, replace the first Sp token
    embeddings (they are not prepended); the default positions are
    0..S-1, on all three streams under M-RoPE.  An encoder arch runs
    :func:`run_encoder` on the frames once, and aux["enc_out"] holds its
    output (what :func:`decode_step` takes as ``enc_out``).

    Returns (logits (B, S, V) in ``policy.output_dtype``, aux).  Weights
    are cast to ``policy.compute_dtype`` where they are used.  ``remat``
    applies sequential checkpointing to the block stack when autograd is
    on; each block tags its attention and FFN outputs ``"attn_out"`` and
    ``"ffn_out"`` for ``remat.save_names``, as the JAX block does.  With
    ``build_cache`` (serving prefill) aux["cache"] is a decode cache
    positioned at S in the ``init_cache`` layout.  ``return_hidden``
    returns the final normed hidden state (B, S, D) in place of the
    logits (the chunked CE of :func:`loss_fn`).

    ``mesh`` (a model axis > 1): ``model`` is this rank's block (see the
    module docstring); the logits are whole on every rank, and the cache
    holds this rank's KV heads in heads mode, every head in sequence mode
    (where the pool keeps this rank's slice of the positions:
    ``serve/cache_pool.py`` ``scatter_request``)."""
    check_mesh(cfg, mesh)
    tokens = batch["tokens"]
    b, s = tokens.shape
    dt = policy.compute_dtype
    x = _embed(model, cfg, tokens, mesh).to(dt)             # (B, S, D)
    if cfg.family == "vlm" and "patches" in batch:
        patches = batch["patches"].to(dt) @ model.patch_proj.to(dt)
        x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        if cfg.mrope_sections is not None:
            positions = positions.expand(3, b, s)
    enc_out = None
    if cfg.encoder is not None:
        enc_out = run_encoder(model, cfg, batch["frames"], policy, mesh)
    entries = []
    # a tag is a copy: only where a save_names policy will keep it
    tags = remat.tags if torch.is_grad_enabled() and not build_cache \
        else frozenset()

    def tag(t, name):
        return checkpoint_name(t, name) if name in tags else t

    def block(carry, layer):
        x, aux_sum = carry
        blk, window = layer
        h = rms_norm(x, blk.ln1.to(dt), cfg.norm_eps,
                     bf16_grad=cfg.norm_bf16_grad)
        entry, a_out, s_out = {}, None, None
        if isinstance(blk.attn, MLA):
            a_out, (lat, kr) = attn.mla_block(blk.attn, h, cfg,
                                              positions=positions, mesh=mesh)
            if build_cache:
                entry.update(mla_lat=lat, mla_rope=kr[:, :, 0])
        elif blk.attn is not None:
            a_out, (k, v) = attn.attn_block(
                blk.attn, h, cfg, positions=positions, window=window,
                resid_dtype=policy.flash_resid_dtype, mesh=mesh)
            if build_cache:
                entry.update(_kv_entry(k, v, quantized=cache_quantized))
        if blk.ssm is not None:
            s_out, state = ssm_mod.ssm_block(blk.ssm, h, cfg,
                                             return_state=build_cache)
            if build_cache:
                entry.update(state)
        if build_cache:
            entries.append(entry)
        x = x + tag(_mix(blk, cfg, a_out, s_out), "attn_out")
        if blk.xattn is not None:
            hx = rms_norm(x, blk.ln_x.to(dt), cfg.norm_eps,
                          bf16_grad=cfg.norm_bf16_grad)
            x = x + _cross_attend(blk, cfg, hx, enc_out, mesh)
        if blk.ffn is None:                  # pure-SSM blocks have no MLP
            return x, aux_sum
        h2 = rms_norm(x, blk.ln2.to(dt), cfg.norm_eps,
                      bf16_grad=cfg.norm_bf16_grad)
        f, aux = ffn_apply(blk.ffn, h2, cfg, dt, mesh=mesh)
        if cfg.moe is not None:
            aux_sum = aux_sum + aux
        return x + tag(f, "ffn_out"), aux_sum

    # each layer gets its own window as a Python int, so every layer of a
    # windowed hybrid reaches the flash kernel; the cache entries are
    # collected as a side effect: no recompute there.  The carry also sums
    # the layers' MoE aux (a remat segment recomputes it with its block)
    x, aux_sum = remat_scan(
        block, (x, torch.zeros((), device=tokens.device)),
        list(zip(model.blocks, layer_windows(cfg))),
        config=CheckpointConfig(enabled=False) if build_cache else remat)
    x = rms_norm(x, model.final_norm.to(dt), cfg.norm_eps,
                 bf16_grad=cfg.norm_bf16_grad)
    # the mean over layers of each layer's aux (JAX: jnp.mean over the scan)
    aux = {"moe_aux": aux_sum / cfg.n_layers if cfg.moe is not None
           else 0.0}
    if build_cache:
        aux["cache"] = _assemble_cache(entries, s, tokens.device)
    if enc_out is not None:
        aux["enc_out"] = enc_out
    if return_hidden:
        return x, aux
    return head_logits(model, cfg, x, policy, mesh), aux


def _ce_terms(logits32, labels):
    """Per-token NLL from f32 logits: the row max taken without gradient,
    the label logit picked by comparing a vocab iota with the label
    instead of gathering (the JAX package's sharding-friendly CE)."""
    shifted = logits32 - logits32.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    vocab_iota = torch.arange(logits32.shape[-1], device=logits32.device)
    label_logit = torch.where(vocab_iota == labels[..., None].long(),
                              shifted, torch.zeros((), device=shifted.device)
                              ).sum(dim=-1)
    return lse - label_logit


class _VocabParallelCE(torch.autograd.Function):
    """Per-token NLL from this rank's f32 block of the logits (the vocab
    split over the model group); the forward reduces the row max (MAX),
    the sum of ``exp`` and the label's shifted logit (SUM, non-zero on
    the one rank whose block holds it) over the group.  The backward is
    ``softmax_block - onehot_block`` times the upstream gradient, from
    the saved block and the reduced statistics: no collective."""

    @staticmethod
    def forward(ctx, logits, labels, offset: int, group):
        sum_ = dist.ReduceOp.SUM
        m = collectives.all_reduce_f32(logits.amax(dim=-1),
                                       dist.ReduceOp.MAX, group)
        shifted = logits - m[..., None]
        total = collectives.all_reduce_f32(torch.exp(shifted).sum(dim=-1),
                                           sum_, group)
        local = labels.long() - offset
        label_logit = collectives.all_reduce_f32(
            torch.where(_hits(logits, local), shifted, torch.zeros(
                (), device=shifted.device)).sum(dim=-1), sum_, group)
        ctx.save_for_backward(logits, m, total, local)
        return torch.log(total) - label_logit

    @staticmethod
    def backward(ctx, g):
        logits, m, total, local = ctx.saved_tensors
        p = torch.exp(logits - m[..., None]) / total[..., None]
        return ((p - _hits(logits, local).to(p.dtype)) * g[..., None],
                None, None, None)


def _hits(logits, local):
    """(..., V_l) bool: where this block's vocab index is the label
    (``local``: the label less the block's first global index)."""
    return torch.arange(logits.shape[-1], device=logits.device) \
        == local[..., None]


def vocab_parallel_ce(logits32, labels, mesh):
    """Per-token NLL (..., ) from ``logits32`` (..., V / n), this rank's f32
    block of the vocab on ``mesh``'s model axis (its padded tail already
    masked by global index), against global ``labels``: the reference's
    CE (``repro/models/transformer.py:453-467``) with the vocab never
    gathered.  Every rank gets the same NLL."""
    group, n, r = collectives.model_axis(mesh)
    if n == 1:
        return _ce_terms(logits32, labels)
    return _VocabParallelCE.apply(logits32, labels, r * logits32.shape[-1],
                                  group)


def loss_fn(model: Transformer, cfg: ModelConfig, batch: dict, *,
            policy: Policy = Policy.full(),
            remat: CheckpointConfig = CheckpointConfig(),
            moe_aux_weight: float = 0.01, ce_chunk: int = 0, mesh=None):
    """Mean next-token cross entropy over ``batch["loss_mask"]`` (default
    all ones), plus ``moe_aux_weight`` times the layers' mean MoE aux for
    an MoE arch -> (loss, {"nll": loss, "moe_aux": ...}); as in the JAX
    package, ``nll`` is the loss with the aux term.

    The CE of the JAX package (``transformer.py:420-467``), in f32.  With
    ``ce_chunk > 0`` the LM head and the softmax run per sequence chunk of
    that many tokens (the last one ragged), each under ``checkpoint``, so
    the (B, S, V) logits never exist at once: the peak holds one (B,
    chunk, V) block, recomputed in the backward.

    ``mesh`` (a model axis > 1): ``model`` is this rank's block and the
    head holds its block of the vocab.  The final hidden state enters the
    head through ``collectives.copy_to_model`` and the CE is
    :func:`vocab_parallel_ce` on this rank's (B, S, V / n) logits (per
    chunk with ``ce_chunk``): the whole vocab never exists on one rank,
    and every rank returns the same loss."""
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    if ce_chunk > 0 or model.head.shape[-1] != cfg.padded_vocab:
        hidden, aux = forward(model, cfg, batch, policy=policy, remat=remat,
                              return_hidden=True, mesh=mesh)
        hidden = collectives.copy_to_model(hidden, mesh)
        head = model.head.to(policy.compute_dtype)
        off = collectives.model_axis(mesh)[2] * head.shape[-1]

        def block_nll(x_c, lab_c, mask_c):
            logits = _mask_padded_vocab((x_c @ head).float(), cfg,
                                        offset=off)
            return (vocab_parallel_ce(logits, lab_c, mesh) * mask_c).sum()

        step = ce_chunk if ce_chunk > 0 else hidden.shape[1]
        if ce_chunk > 0 and torch.is_grad_enabled():
            block_nll = functools.partial(checkpoint, block_nll,
                                          use_reentrant=False)
        total = sum(block_nll(hidden[:, c:c + step], labels[:, c:c + step],
                              mask[:, c:c + step])
                    for c in range(0, hidden.shape[1], step))
        loss = total / torch.clamp(mask.sum(), min=1.0)
    else:
        logits, aux = forward(model, cfg, batch, policy=policy, remat=remat,
                              mesh=mesh)
        nll = _ce_terms(logits.float(), labels)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if cfg.moe is not None:
        loss = loss + moe_aux_weight * aux["moe_aux"]
    return loss, {"nll": loss, **aux}


# ---------------------------------------------------------------------------
# KV cache and single-token decode.
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, s_max: int, *,
               quantized: bool = True, dtype=torch.bfloat16,
               device="cuda", mesh=None) -> dict:
    """A 0-d ``pos``; for attention, (L, B, Hkv, S, hd) int8 K/V
    (``dtype`` when not quantized) plus (L, B, Hkv, S) f32 scales; for
    MLA, the latents ``mla_lat`` (L, B, S, kv_lora) and ``mla_rope``
    (L, B, S, dr) in ``dtype`` (``quantized`` does not apply); for the
    SSM, the conv tail (L, B, K-1, conv_dim) in ``dtype`` and the state
    (L, B, H, N, P) in f32.  An encoder-decoder caches only its
    self-attention: the cross-attention's K / V are projected from
    ``enc_out`` at every step, as in the reference.  With ``mesh`` each
    leaf has this rank's block's shape under
    :func:`cache_specs`: the KV heads or the ``s_max`` slots over the
    model axis (the serve pool's layout), MLA's latents by sequence; the
    conv tail and the SSM state are whole on every rank
    (``sharding.cache_specs`` splits them over DP only)."""
    L = cfg.n_layers
    check_mesh(cfg, mesh)
    z = functools.partial(_block_zeros, cfg, mesh, device)
    cache = {"pos": z((), torch.int32)}
    if cfg.mla is not None:
        m = cfg.mla
        cache.update(
            mla_lat=z((L, batch, s_max, m.kv_lora_rank), dtype, "mla_lat"),
            mla_rope=z((L, batch, s_max, m.qk_rope_dim), dtype, "mla_rope"))
    elif cfg.mixer in ("attn", "hybrid"):
        shape = (L, batch, cfg.n_kv, s_max, cfg.head_dim)
        kv_dtype = torch.int8 if quantized else dtype
        cache.update(k=z(shape, kv_dtype, "k"), v=z(shape, kv_dtype, "v"),
                     k_scale=z(shape[:-1], torch.float32, "k_scale"),
                     v_scale=z(shape[:-1], torch.float32, "v_scale"))
    if cfg.mixer in ("ssm", "hybrid"):
        s = cfg.ssm
        cache["conv"] = z((L, batch, s.conv_kernel - 1,
                           s.d_inner + 2 * s.d_state), dtype)
        cache["ssm"] = z((L, batch, s.heads, s.d_state, s.head_p),
                         torch.float32)
    return cache


def _block_zeros(cfg: ModelConfig, mesh, device, shape, dtype, name=None):
    """Zeros of this rank's block of the cache leaf ``name`` of global
    ``shape`` on ``mesh`` (:func:`cache_specs`); the whole leaf without a
    model axis or a name."""
    if _model_n(mesh) > 1 and name is not None:
        shape = shd.local_shape(shape, cache_specs(cfg, {name: shape},
                                                   mesh)[name], mesh)
    return torch.zeros(shape, dtype=dtype, device=device)


def cache_specs(cfg: ModelConfig, cache: dict, mesh) -> dict:
    """``{name: spec}`` of a decode cache's leaves (``{name: tensor or
    shape}``) on ``mesh``'s model axis: ``sharding.serve_cache_specs``
    (the KV heads, or the sequence, over the axis) for the uniform
    cache's K / V, the same for each tier of the two-tier cache's (``gk``
    ... ``wv_scale``, by its own slots: a rolling window whose slots do
    not divide the axis stays whole, as in the reference's
    ``cache_specs``), and MLA's latents by sequence (a ValueError where
    the slots do not divide); every other leaf whole."""
    n = _model_n(mesh)
    out = {}
    for name, leaf in cache.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        base = name[1:] if name[:1] in ("g", "w") and name[1:] in (
            "k", "v", "k_scale", "v_scale") else name
        if name in ("mla_lat", "mla_rope") and n > 1:
            if shape[2] % n:
                raise ValueError(f"{cfg.arch_id}: MLA's {shape[2]} latent "
                                 f"cache slots do not split over a model "
                                 f"axis of {n}")
            out[name] = (None, None, "model", None)
        else:
            out[name] = shd.serve_cache_specs(cfg, {base: shape}, mesh)[base]
    return out


def seq_block(cfg: ModelConfig, mesh, s_max: int) -> tuple[int, int]:
    """(first global position, slots) of this rank's block of an
    ``s_max``-slot cache (:func:`init_cache` with ``mesh``): ``(r s_max /
    n, s_max / n)`` when the model axis splits the sequence
    (``sharding.serve_kv_shard``; always for MLA's latents), ``(0,
    s_max)`` otherwise."""
    n = _model_n(mesh)
    if n == 1:
        return 0, s_max
    if cfg.mla is not None:
        kv = "none" if s_max % n else "seq"
    else:
        kv = shd.serve_kv_shard(mesh, cfg.n_kv, s_max)
    if kv == "none":
        raise ValueError(f"neither {cfg.n_kv} KV heads nor {s_max} cache "
                         f"slots split over a model axis of {n}")
    if kv == "heads":
        return 0, s_max
    s_l = s_max // n
    return mesh_mod.coords(mesh)["model"] * s_l, s_l


def place_seq(dst, src, ax: int, seq_offset: int = 0):
    """In place: ``dst``, which holds the global positions ``[seq_offset,
    seq_offset + dst.shape[ax])`` along ``ax``, takes ``src``'s
    (positions from 0, any number of them) where ``src`` has them, and
    zeros where it does not.  -> ``dst``."""
    n = max(0, min(src.shape[ax] - seq_offset, dst.shape[ax]))
    if n:
        dst.narrow(ax, 0, n).copy_(src.narrow(ax, seq_offset, n))
    dst.narrow(ax, n, dst.shape[ax] - n).zero_()
    return dst


def grow_cache(cache: dict, s_max: int, *, cfg: ModelConfig | None = None,
               mesh=None) -> dict:
    """Zero-pad every sequence-bearing cache leaf out to ``s_max`` slots.
    With ``mesh`` (and ``cfg``), a cache :func:`forward` built on it is
    put in this rank's decode layout (:func:`init_cache`'s): its block
    of the ``s_max`` positions (:func:`seq_block`; the heads are already
    this rank's).  A cache with no sequence axis (the pure SSM's) is
    returned as it is."""
    names = [n for n in CACHE_SEQ_AXES if n in cache]
    off, s_l = seq_block(cfg, mesh, s_max) if names else (0, s_max)
    out = dict(cache)
    for name in names:
        ax = CACHE_SEQ_AXES[name]
        x = cache[name]
        if x.shape[ax] > s_max:
            raise ValueError(f"grow_cache: {name} already has "
                             f"{x.shape[ax]} > {s_max} slots")
        if (off, s_l) != (0, x.shape[ax]):
            shape = list(x.shape)
            shape[ax] = s_l
            out[name] = place_seq(x.new_empty(shape), x, ax, off)
    return out


def decode_step(model: Transformer, cfg: ModelConfig, cache: dict, tokens_t,
                *, policy: Policy = Policy.full(), quantized: bool = True,
                kvq_splits: int = 1, active=None, enc_out=None, mesh=None):
    """tokens_t: (B,) int current token.  Returns (logits (B, V), cache).
    ``enc_out`` (B, Se, D): the encoder's output (``forward``'s
    aux["enc_out"]), which an encoder arch's layers attend over.

    The cache's leaves (K/V, MLA latents, conv tail, SSM state) are
    updated in place; the returned dict holds the same buffers and the
    advanced ``pos``.
    Each attention layer masks by length (full causal) or by a window
    band's bias (:func:`attn.decode_mask`), built once a step for each
    distinct window and shared by its layers.  With a per-row (B,) ``pos``
    (slot-pooled serving, GQA caches only) every row decodes at its own
    position, and ``active`` ((B,) bool) gates the position increment so
    free slots stay frozen; their lengths stay >= 1 and their logits are
    never read.

    ``mesh`` (a model axis > 1): ``model`` and ``cache`` are this rank's
    blocks (:func:`init_params`, :func:`init_cache` with ``mesh``); the
    cache's layout is ``sharding.serve_kv_shard``'s -- "heads", or "seq"
    (this rank holds S_l of the S slots and every layer decodes through
    ``collectives.sp_decode_attention_int8``; MLA's latents always by
    sequence, ``attention.mla_decode``) -- and the logits are whole on
    every rank."""
    check_mesh(cfg, mesh)
    pos = cache["pos"]
    per_slot = pos.ndim == 1
    if per_slot and (cfg.mixer != "attn" or cfg.mla is not None):
        raise NotImplementedError(
            "per-slot decode (vector cache['pos']) is only supported for "
            "GQA attention caches (the kvq layout); MLA/SSM/hybrid archs "
            "serve through the scalar-pos path")
    if active is not None and not per_slot:
        raise ValueError("decode_step: active mask requires a per-slot "
                         "(vector) cache['pos']")
    if (cfg.encoder is not None) != (enc_out is not None):
        raise ValueError(f"decode_step: {cfg.arch_id} takes enc_out only "
                         f"with an encoder, and always then")
    x = _embed(model, cfg, tokens_t, mesh)                  # (B, D)
    kv_shard, s_all = "none", 0
    if "k" in cache:
        n = _model_n(mesh)
        s_all = cache["k"].shape[3] * (n if cfg.n_kv % n else 1)
        kv_shard = shd.serve_kv_shard(mesh, cfg.n_kv, s_all)
    masks = {}                                              # window -> mask
    for i, (blk, window) in enumerate(zip(model.blocks, layer_windows(cfg))):
        def attend(h, blk=blk, i=i, window=window):
            if isinstance(blk.attn, MLA):
                return attn.mla_decode(blk.attn, h, cfg, cache["mla_lat"][i],
                                       cache["mla_rope"][i], pos,
                                       mesh=mesh)[0]
            if window not in masks:
                masks[window] = attn.decode_mask(pos, x.shape[0], s_all,
                                                 window)
            return attn.attn_decode(
                blk.attn, h, cfg, cache["k"][i], cache["k_scale"][i],
                cache["v"][i], cache["v_scale"][i], pos, window=window,
                mask=masks[window], quantized=quantized, splits=kvq_splits,
                mesh=mesh, kv_shard=kv_shard)[0]

        x = _decode_block(blk, cfg, x, cache, i, attend, enc_out, mesh)
    new_cache = dict(cache)
    new_cache["pos"] = pos + (active.to(torch.int32) if active is not None
                              else 1)
    return _decode_logits(model, cfg, x, policy, mesh), new_cache


def _decode_block(blk, cfg, x, cache, i, attend, enc_out=None, mesh=None):
    """One layer of a decode step: ``attend(h)`` the layer's attention over
    its cache, the SSM's step on ``cache["conv"][i]`` / ``["ssm"][i]``
    (updated in place), the mix, the cross-attention over ``enc_out``
    (encoder archs) and the MLP."""
    h = rms_norm(x[:, None], blk.ln1, cfg.norm_eps)[:, 0]
    a_out = attend(h) if blk.attn is not None else None
    s_out = None
    if blk.ssm is not None:
        s_out, conv, state = ssm_mod.ssm_decode_step(
            blk.ssm, h, cfg, cache["conv"][i], cache["ssm"][i])
        cache["conv"][i] = conv
        cache["ssm"][i] = state
    x = x + _mix(blk, cfg, a_out, s_out)
    if blk.xattn is not None:
        hx = rms_norm(x[:, None], blk.ln_x, cfg.norm_eps)
        x = x + _cross_attend(blk, cfg, hx, enc_out, mesh)[:, 0]
    if blk.ffn is not None:
        # the MoE routes the (B, 1, D) step as B tokens, every row of the
        # batch (a free slot too) taking capacity, as in the JAX package
        h2 = rms_norm(x[:, None], blk.ln2, cfg.norm_eps)
        x = x + ffn_apply(blk.ffn, h2, cfg, mesh=mesh)[0][:, 0]
    return x


def _decode_logits(model, cfg, x, policy, mesh=None):
    x = rms_norm(x[:, None], model.final_norm, cfg.norm_eps)[:, 0]
    return head_logits(model, cfg, x, policy, mesh)


# ---------------------------------------------------------------------------
# Two-tier cache (windowed archs): the global layers keep the whole context,
# the window layers a rolling buffer of ``window`` slots (hymba: 29 of its
# 32 layers keep 1024 slots instead of the context).  A decode-only path
# from an empty cache, as in the JAX package (``transformer.py:477-600``).
# ---------------------------------------------------------------------------
def layer_runs(cfg: ModelConfig) -> list[tuple[int, int, bool]]:
    """Contiguous layer runs [(lo, hi, is_global)], in order."""
    glob = set(cfg.global_layers)
    runs: list[tuple[int, int, bool]] = []
    for i in range(cfg.n_layers):
        is_g = i in glob
        if runs and runs[-1][2] == is_g:
            runs[-1] = (runs[-1][0], i + 1, is_g)
        else:
            runs.append((i, i + 1, is_g))
    return runs


def _tier_slots(cfg: ModelConfig) -> list[tuple[str, int]]:
    """Per layer: its tier (``"g"`` / ``"w"``) and its index in that tier's
    stacked leaves."""
    slots, count = [], {"g": 0, "w": 0}
    for lo, hi, is_global in layer_runs(cfg):
        tier = "g" if is_global else "w"
        for _ in range(lo, hi):
            slots.append((tier, count[tier]))
            count[tier] += 1
    return slots


def init_cache_two_tier(cfg: ModelConfig, batch: int, s_max: int, *,
                        quantized: bool = True, dtype=torch.bfloat16,
                        device="cuda", mesh=None) -> dict:
    """A 0-d ``pos``; for each tier ``g`` (the global layers, ``s_max``
    slots) and ``w`` (the window layers, ``min(window, s_max)`` slots):
    ``{tier}k`` / ``{tier}v`` (n_tier, B, Hkv, S_tier, hd) int8 (``dtype``
    when not quantized) and ``{tier}k_scale`` / ``{tier}v_scale`` f32; for
    the hybrid, ``conv`` and ``ssm`` as :func:`init_cache`'s.

    With ``mesh`` (a model axis > 1) each tier is this rank's block as
    the reference's ``cache_specs`` places it (:func:`cache_specs`): by
    KV heads where they divide the axis; else by sequence where the
    tier's slots divide it (a rolling window whose slots do not stays
    whole, every rank reading all of it); the global tier's ``s_max``
    slots must divide then (a ValueError: :func:`decode_step_two_tier`
    reads the window tier's layout off the global tier's).  The conv
    tail and the SSM state are whole on every rank."""
    n = _model_n(mesh)
    check_mesh(cfg, mesh)
    if n > 1 and shd.serve_kv_shard(mesh, cfg.n_kv, s_max) == "none":
        raise ValueError(f"{cfg.arch_id}: neither {cfg.n_kv} KV heads "
                         f"nor the global tier's {s_max} slots split over "
                         f"a model axis of {n}")
    if not (cfg.window > 0 and cfg.global_layers
            and cfg.mixer in ("attn", "hybrid")):
        raise ValueError(f"{cfg.arch_id}: the two-tier cache needs a "
                         f"windowed attention arch with global layers")
    L = cfg.n_layers
    n_g = len([g for g in cfg.global_layers if g < L])
    z = functools.partial(_block_zeros, cfg, mesh, device)
    kv_dtype = torch.int8 if quantized else dtype
    cache = {"pos": z((), torch.int32)}
    for tier, n_t, s_t in (("g", n_g, s_max),
                           ("w", L - n_g, min(cfg.window, s_max))):
        shape = (n_t, batch, cfg.n_kv, s_t, cfg.head_dim)
        for leaf in ("k", "v"):
            cache[f"{tier}{leaf}"] = z(shape, kv_dtype, f"{tier}{leaf}")
            cache[f"{tier}{leaf}_scale"] = z(shape[:-1], torch.float32,
                                             f"{tier}{leaf}_scale")
    if cfg.mixer == "hybrid":
        s = cfg.ssm
        cache["conv"] = z((L, batch, s.conv_kernel - 1,
                           s.d_inner + 2 * s.d_state), dtype)
        cache["ssm"] = z((L, batch, s.heads, s.d_state, s.head_p),
                         torch.float32)
    return cache


def _tier_layouts(cfg: ModelConfig, cache: dict, mesh) -> dict:
    """{tier: (layout, its global slots)} of a two-tier cache on ``mesh``
    (:func:`init_cache_two_tier`'s placement): "heads", "seq" or "none"
    (``attention.attn_decode``'s ``kv_shard``)."""
    s_g = cache["gk"].shape[3]
    if shd.serve_kv_shard(mesh, cfg.n_kv, s_g) != "heads":
        s_g *= _model_n(mesh)           # the global tier by sequence
    tiers = {"g": s_g, "w": min(cfg.window, s_g)}
    return {t: (shd.serve_kv_shard(mesh, cfg.n_kv, s), s)
            for t, s in tiers.items()}


def decode_step_two_tier(model: Transformer, cfg: ModelConfig, cache: dict,
                         tokens_t, *, policy: Policy = Policy.full(),
                         quantized: bool = True, kvq_splits: int = 1,
                         mesh=None):
    """One token over a two-tier cache (:func:`init_cache_two_tier`).

    Every layer masks by length and builds no bias: a window layer rolls
    its buffer (writes at ``pos % W``, ``lengths = min(pos + 1, W)``), a
    global layer reads ``lengths = pos + 1``.  The cache's leaves are
    updated in place; returns (logits (B, V), the cache with ``pos``
    advanced).

    ``mesh`` (a model axis > 1): ``model`` and ``cache`` are this rank's
    blocks.  The FFN and the MoE split over the axis as in
    :func:`decode_step`, the SSM whole on every rank, the attention by
    heads where the cache is, else whole with each tier read over its
    block of the slots through ``collectives.sp_decode_attention_int8``
    -- a rolling window too: its slots fill in order and are then
    overwritten, and the softmax over them does not depend on their
    order, so the write lands at ``pos % W`` on the rank owning that
    slot and the lengths are ``min(pos + 1, W)`` -- and the logits are
    whole on every rank."""
    pos = cache["pos"]
    x = _embed(model, cfg, tokens_t, mesh)
    b = x.shape[0]
    tiers = _tier_layouts(cfg, cache, mesh)
    masks = {"g": attn.decode_mask(pos, b, tiers["g"][1], 0),
             "w": attn.rolling_mask(pos, b, tiers["w"][1])}
    for i, (blk, (tier, k)) in enumerate(zip(model.blocks,
                                             _tier_slots(cfg))):
        def attend(h, blk=blk, tier=tier, k=k):
            return attn.attn_decode(
                blk.attn, h, cfg, cache[f"{tier}k"][k],
                cache[f"{tier}k_scale"][k], cache[f"{tier}v"][k],
                cache[f"{tier}v_scale"][k], pos, mask=masks[tier],
                quantized=quantized, splits=kvq_splits,
                rolling=tier == "w", mesh=mesh, kv_shard=tiers[tier][0])[0]

        x = _decode_block(blk, cfg, x, cache, i, attend, mesh=mesh)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return _decode_logits(model, cfg, x, policy, mesh), new_cache
