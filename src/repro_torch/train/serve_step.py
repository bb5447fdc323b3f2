"""Serving steps: prefill (forward + cache build) and decode (counterpart
of ``repro.train.serve_step``).

Decode is the paper's E-D insight deployed: the KV cache lives int8-encoded
(``kernels/kvq``) and is dequantized inside the attention read.

Over a ``launch/mesh.py`` ``Mesh`` whose model axis is > 1, each rank runs
the steps on its block of the weights and of the cache
(``models/transformer.py``'s module docstring), and every rank returns the
same, whole logits.  PyTorch compiles nothing here: where the reference's
:func:`make_serve_steps` jits a step with ``in_shardings``, this one
returns the step and this rank's parameter placement, and the step takes
this rank's rows of the batch by ``sharding.batch_specs``.
"""
from __future__ import annotations

from repro_torch.core.mixed_precision import get_policy
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def build_prefill_step(cfg: ModelConfig, *, policy_name: str = "bf16",
                       quantized: bool = True, s_max: int | None = None,
                       mesh=None):
    """-> ``prefill_step(model, batch)`` returning (the last position's
    logits (B, V), the primed cache).

    ``s_max``: the cache is grown to its final length (prompt +
    generation) before it is returned (``transformer.grow_cache``; the
    prompt's length without it).  Only the last position goes through the
    head.  With ``mesh`` the cache is in the decode layout of this rank:
    its KV heads, or its block of the slots (``transformer.seq_block``;
    MLA's latents by sequence)."""
    policy = get_policy(policy_name)

    def prefill_step(model, batch):
        x, aux = transformer.forward(
            model, cfg, batch, policy=policy, build_cache=True,
            cache_quantized=quantized, return_hidden=True, mesh=mesh)
        cache = transformer.grow_cache(
            aux["cache"], s_max or batch["tokens"].shape[1], cfg=cfg,
            mesh=mesh)
        return (transformer.head_logits(model, cfg, x[:, -1], policy, mesh),
                cache)

    return prefill_step


def build_decode_step(cfg: ModelConfig, *, policy_name: str = "bf16",
                      quantized: bool = True, kvq_splits: int = 1,
                      mesh=None):
    """-> ``step(model, cache, tokens_t[, enc_out])`` returning (logits
    (B, V), cache), the cache's leaves updated in place."""
    policy = get_policy(policy_name)

    def step(model, cache, tokens_t, enc_out=None):
        kw = {"enc_out": enc_out} if cfg.encoder is not None else {}
        return transformer.decode_step(
            model, cfg, cache, tokens_t, policy=policy, quantized=quantized,
            kvq_splits=kvq_splits, mesh=mesh, **kw)

    return step


def _rows(cfg, batch: dict, mesh, where) -> dict:
    """This rank's rows of ``batch``, each leaf split over the DP axes by
    ``sharding.batch_specs`` (``sharding.shard_leaf`` raises where they do
    not divide)."""
    return {name: shd.shard_leaf(batch[name], spec, mesh, where)
            for name, spec in shd.batch_specs(cfg, batch, mesh).items()}


def make_serve_steps(cfg: ModelConfig, mesh, input_sds: dict, *,
                     kind: str, policy_name: str = "bf16",
                     quantized: bool = True, kvq_splits: int = 1,
                     s_max: int | None = None):
    """The prefill or decode step over ``mesh``, and this rank's parameter
    placement ``{name: spec}`` (``transformer.param_shard_specs``: what
    :func:`transformer.init_params` / ``bridge.load_jax_params`` with
    ``mesh`` cut the model to).

    ``input_sds``: the prefill's batch (``{"tokens": (B, S) ...}``, an
    encoder arch's with its ``frames``), or the decode's ``{"cache": ...,
    "tokens_t": (B,)}`` (and ``enc_out`` for an encoder arch; tensors or
    shapes, only their shapes are read).  The step takes the global
    batch, or the cache in this rank's layout, the global tokens and the
    global ``enc_out`` (``transformer.run_encoder(mesh=)`` on the global
    frames: whole on every rank), and runs on this rank's rows
    (``sharding.batch_specs``; decode tokens and ``enc_out`` split over
    DP only where they divide, as the reference's).  ``s_max``: the
    prefill's cache length, prompt + generation (as
    :func:`build_prefill_step`'s; the decode cells' cache arrives at that
    length)."""
    check = transformer.init_params(cfg, device="meta")
    placement = transformer.param_shard_specs(
        cfg, {n: tuple(p.shape) for n, p in check.named_parameters()}, mesh)
    where = mesh_mod.coords(mesh)
    if kind == "prefill":
        fn = build_prefill_step(cfg, policy_name=policy_name,
                                quantized=quantized, s_max=s_max, mesh=mesh)
        shd.batch_specs(cfg, input_sds, mesh)          # every leaf has one

        def prefill(model, batch):
            return fn(model, _rows(cfg, batch, mesh, where))
        return prefill, placement

    if kind != "decode":
        raise ValueError(f"make_serve_steps: kind {kind!r}")
    fn = build_decode_step(cfg, policy_name=policy_name, quantized=quantized,
                           kvq_splits=kvq_splits, mesh=mesh)

    def decode(model, cache, tokens_t, enc_out=None):
        # the reference's tok_shard: over DP where the rows divide, else
        # every rank takes them all; the encoder's output likewise
        n_dp = shd.dp_size(mesh)
        rows = {k: v for k, v in (("tokens_t", tokens_t),
                                  ("enc_out", enc_out))
                if v is not None and v.shape[0] % n_dp == 0}
        rows = _rows(cfg, rows, mesh, where)
        return fn(model, cache, rows.get("tokens_t", tokens_t),
                  rows.get("enc_out", enc_out))
    return decode, placement
