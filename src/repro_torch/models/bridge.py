"""Parameter bridge between the JAX param pytree and the port's modules.

The JAX side hands over its tree as numpy arrays
(``jax.tree.map(np.asarray, params)``); nothing here imports JAX.  The
stacked ``(L, ...)`` block leaves are sliced into per-layer modules, the
padded-vocab rows are kept, and weights keep their ``(d_in, d_out)``
orientation, so every leaf is a plain copy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mixed_precision import Policy
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Attention, Block, SwiGLU,
                                            Transformer)

_ATTN = ("wq", "wk", "wv", "wo")
_FFN = ("w_gate", "w_up", "w_down")


def load_jax_params(cfg: ModelConfig, tree: dict, *, device="cuda",
                    policy: Policy | None = None) -> Transformer:
    """JAX param tree of numpy arrays -> :class:`Transformer` on ``device``,
    cast once to ``policy.compute_dtype`` when a policy is given."""
    def t(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    blocks_tree = tree["blocks"]
    blocks = []
    for i in range(cfg.n_layers):
        a, f = blocks_tree["attn"], blocks_tree["ffn"]
        blocks.append(Block(
            t(blocks_tree["ln1"][i]), t(blocks_tree["ln2"][i]),
            Attention(*(t(a[name][i]) for name in _ATTN)),
            SwiGLU(*(t(f[name][i]) for name in _FFN))))
    model = Transformer(cfg, t(tree["embed"]), blocks, t(tree["final_norm"]),
                        None if cfg.tie_embeddings else t(tree["lm_head"]))
    return model if policy is None else model.cast_to_compute(policy)


def export_params(model: Transformer) -> dict:
    """The reverse of :func:`load_jax_params`: a JAX-layout tree of numpy
    arrays with the per-layer leaves stacked along a leading layer axis."""
    def n(p):
        return p.detach().cpu().numpy()

    blocks = model.blocks
    tree = {
        "embed": n(model.embed),
        "final_norm": n(model.final_norm),
        "blocks": {
            "ln1": np.stack([n(b.ln1) for b in blocks]),
            "ln2": np.stack([n(b.ln2) for b in blocks]),
            "attn": {name: np.stack([n(getattr(b.attn, name))
                                     for b in blocks]) for name in _ATTN},
            "ffn": {name: np.stack([n(getattr(b.ffn, name))
                                    for b in blocks]) for name in _FFN},
        },
    }
    if model.lm_head is not None:
        tree["lm_head"] = n(model.lm_head)
    return tree
