"""Bridge between the JAX package's layout and the port's modules.

The JAX side hands over its trees as numpy arrays
(``jax.tree.map(np.asarray, tree)``); nothing here imports JAX.  In the
JAX layout the per-layer leaves are stacked along a leading layer axis
under ``"blocks"`` (and an encoder's under ``"enc_blocks"``); the port
holds one module per layer, whose parameters are named
``blocks.<i>.<path>`` (``enc_blocks.<i>.<path>``).  A tied arch has no
``lm_head`` on either side.  The padded-vocab rows are kept, and
weights keep their ``(d_in, d_out)`` orientation, so every leaf is a
plain copy.  The same layout carries the AdamW moments, so a training
checkpoint of either package restores into the other.

On a mesh's model axis each rank holds its block of every sharded leaf
(``transformer.param_placement``): the loaders cut the global arrays
(``mesh=``), and the exporters gather them back whole, one leaf at a
time over the model group, on rank 0 (:func:`gather_named`), so a
checkpoint holds the same global arrays whatever mesh wrote it.

The CNN (``models/cnn.py``) has its own pair, :func:`load_cnn_params` and
:func:`export_cnn_params`: the JAX CNN keeps ``blocks`` as a list of
per-block dicts (not stacked), which become ``blocks.<i>.<name>``, and its
convolution weights are HWIO where the port's are OIHW.  Its AdamW moments
take the same mapping.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mixed_precision import Policy
from repro_torch.distributed import collectives
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (MLA, SSM, Attention, Block,
                                            EncBlock, GeluMLP, MoE, SwiGLU,
                                            Transformer, init_params,
                                            param_placement, shard_fn)
from repro_torch.optim.adamw import AdamWState

_ATTN = ("wq", "wk", "wv", "wo")
_FFN = ("w_gate", "w_up", "w_down")     # the dense SwiGLU's leaves
#: the JAX tree's keys whose leaves are stacked along a layer axis
STACKED = ("blocks", "enc_blocks")


def _to_tensor(x, device):
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def load_jax_params(cfg: ModelConfig, tree: dict, *, device="cuda",
                    policy: Policy | None = None, mesh=None,
                    rank: int | None = None) -> Transformer:
    """JAX param tree of numpy arrays -> :class:`Transformer` on ``device``,
    cast once to ``policy.compute_dtype`` when a policy is given.  With
    ``mesh`` (a model axis > 1) only this rank's block of each leaf
    (``transformer.shard_fn``; ``rank`` defaults to this process's) is
    copied to the device."""
    cut = shard_fn(cfg, mesh, rank)

    def t(name, x):
        return _to_tensor(cut(name, np.asarray(x)), device)

    def leaves(pre, sub, names, i):
        return (t(f"{pre}.{n}", sub[n][i]) for n in names if n in sub)

    def dense_ffn(pre, ft, i):
        if "w1" in ft:                             # whisper's GELU MLP
            return GeluMLP(*leaves(pre, ft, GeluMLP.NAMES, i))
        return SwiGLU(*leaves(pre, ft, _FFN, i))

    bt = tree["blocks"]
    blocks = []
    for i in range(cfg.n_layers):
        # each sub-tree is present only where the family has it: pure-SSM
        # layers have no attn or ffn, only the hybrid has the mix norms
        pre = f"blocks.{i}"
        kw = {}
        if "attn" in bt and "q_a" in bt["attn"]:       # MLA's leaves
            kw["attn_mod"] = MLA(*leaves(f"{pre}.attn", bt["attn"],
                                         MLA.NAMES, i))
        elif "attn" in bt:
            kw["attn_mod"] = Attention(*leaves(f"{pre}.attn", bt["attn"],
                                               _ATTN, i))
        if "ssm" in bt:
            kw["ssm"] = SSM(*leaves(f"{pre}.ssm", bt["ssm"], SSM.NAMES, i))
        if "ffn" in bt and "router" in bt["ffn"]:
            # stacked (L, E, D, F) as the JAX tree keeps them
            kw["ffn"] = MoE(*leaves(f"{pre}.ffn", bt["ffn"],
                                    MoE.NAMES + MoE.SHARED, i))
        elif "ffn" in bt:
            kw["ffn"] = dense_ffn(f"{pre}.ffn", bt["ffn"], i)
        if "xattn" in bt:
            kw["xattn"] = Attention(*leaves(f"{pre}.xattn", bt["xattn"],
                                            _ATTN, i))
            kw["ln_x"] = t(f"{pre}.ln_x", bt["ln_x"][i])
        for n in ("mix_norm_attn", "mix_norm_ssm"):
            if n in bt:
                kw[n] = t(f"{pre}.{n}", bt[n][i])
        blocks.append(Block(t(f"{pre}.ln1", bt["ln1"][i]),
                            t(f"{pre}.ln2", bt["ln2"][i]), **kw))
    extra = {}
    if "enc_blocks" in tree:
        et = tree["enc_blocks"]
        extra["enc_blocks"] = [
            EncBlock(t(f"enc_blocks.{i}.ln1", et["ln1"][i]),
                     t(f"enc_blocks.{i}.ln2", et["ln2"][i]),
                     Attention(*leaves(f"enc_blocks.{i}.attn", et["attn"],
                                       _ATTN, i)),
                     dense_ffn(f"enc_blocks.{i}.ffn", et["ffn"], i))
            for i in range(cfg.encoder.n_layers)]
        extra["enc_norm"] = t("enc_norm", tree["enc_norm"])
    if "patch_proj" in tree:
        extra["patch_proj"] = t("patch_proj", tree["patch_proj"])
    model = Transformer(cfg, t("embed", tree["embed"]), blocks,
                        t("final_norm", tree["final_norm"]),
                        None if cfg.tie_embeddings
                        else t("lm_head", tree["lm_head"]), **extra)
    return model if policy is None else model.cast_to_compute(policy)


def to_jax_tree(named: dict, stack=np.stack) -> dict:
    """{port parameter name: tensor or array} -> a JAX-layout tree of numpy
    arrays, the ``blocks.<i>.*`` and ``enc_blocks.<i>.*`` leaves stacked
    along a leading layer axis (by ``stack``, given the layers' arrays in
    order)."""
    tree: dict = {}
    layers: dict = {}
    for name, x in named.items():
        arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
        parts = name.split(".")
        if parts[0] in STACKED:
            layers.setdefault((parts[0], *parts[2:]), {})[int(parts[1])] = arr
        else:
            tree[name] = arr
    for path, per_layer in layers.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = stack([per_layer[i]
                                for i in range(len(per_layer))])
    return tree


def _abstract(shape, dtype=np.float32) -> np.ndarray:
    """A read-only zero-stride array of ``shape``: a leaf's signature, no
    memory."""
    return np.broadcast_to(np.zeros((), dtype), tuple(shape))


def abstract_params(cfg: ModelConfig) -> dict:
    """The JAX-layout tree of ``cfg``'s GLOBAL f32 parameter shapes, every
    leaf a zero-stride array: what a checkpoint written at any mesh must
    fit (``CheckpointManager.restore``'s ``like``), at no memory."""
    named = {n: _abstract(p.shape) for n, p in
             init_params(cfg, device="meta").named_parameters()}
    return to_jax_tree(named, stack=lambda xs: _abstract(
        (len(xs),) + xs[0].shape, xs[0].dtype))


def gather_named(named: dict, cfg: ModelConfig, mesh) -> dict | None:
    """{port name: this rank's block} -> {port name: the whole numpy
    array} on rank 0 of the world, None on the other ranks.  Every rank
    calls it; only the ranks of rank 0's model group (data coordinate 0)
    take part: the sharded leaves are gathered over that group one at a
    time, in name order, so no rank holds more than one whole leaf on the
    device, and no other rank copies anything.  Without a mesh it is this
    rank's own arrays."""
    if mesh is None:
        return {n: x.detach().cpu().numpy() for n, x in named.items()}
    collectives.model_axis(mesh)       # the groups exist on every rank
    if mesh_mod.coords(mesh).get("data", 0) != 0:
        return None
    specs = param_placement(cfg, mesh)
    keep = mesh_mod.rank() == 0
    out = {}
    for name in sorted(named):
        x = named[name].detach()
        dim = None if specs is None else next(
            (d for d, e in enumerate(specs[name]) if e is not None), None)
        if dim is not None:
            x = collectives.model_all_gather(x, mesh, dim=dim)
        if keep:
            out[name] = x.cpu().numpy()
        del x
    return out if keep else None


def from_jax_tree(tree: dict) -> dict:
    """The reverse of :func:`to_jax_tree`: {port parameter name: array}."""
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, prefix + (key,))
            else:
                out[prefix + (key,)] = np.asarray(val)

    walk(tree, ())
    named = {}
    for path, arr in out.items():
        if path[0] in STACKED:
            for i in range(arr.shape[0]):
                named[".".join((path[0], str(i)) + path[1:])] = arr[i]
        else:
            named[".".join(path)] = arr
    return named


def export_params(model: Transformer, mesh=None) -> dict | None:
    """The reverse of :func:`load_jax_params`: a JAX-layout tree of numpy
    arrays with the per-layer leaves stacked along a leading layer axis.
    With ``mesh`` every rank calls it and rank 0 gets the global arrays
    (:func:`gather_named`), the others None."""
    named = gather_named(dict(model.named_parameters()), model.cfg, mesh)
    return None if named is None else to_jax_tree(named)


def export_opt_state(state: AdamWState, mesh=None,
                     cfg: ModelConfig | None = None) -> AdamWState | None:
    """The port's AdamW state -> the JAX layout: moments as stacked trees of
    numpy arrays, the step count as a 0-d int32 array.  With ``mesh`` (and
    ``cfg``) the moments are gathered as :func:`export_params` gathers
    their parameters: the global state on rank 0, None elsewhere."""
    mu = gather_named(state.mu, cfg, mesh)
    nu = gather_named(state.nu, cfg, mesh)
    if mu is None:
        return None
    return AdamWState(mu=to_jax_tree(mu), nu=to_jax_tree(nu),
                      count=np.asarray(state.count.cpu().numpy(),
                                       dtype=np.int32))


def load_opt_state(state, *, device="cuda", cfg: ModelConfig | None = None,
                   mesh=None, rank: int | None = None) -> AdamWState:
    """A JAX-layout AdamW state (``mu``, ``nu``, ``count``, from either
    package) -> the port's, on ``device``.  With ``mesh`` (and ``cfg``; a
    model axis > 1) each moment is cut like its parameter
    (``transformer.shard_fn``; ``rank`` defaults to this process's)."""
    cut = shard_fn(cfg, mesh, rank)

    def moments(tree):
        return {n: _to_tensor(cut(n, a), device)
                for n, a in from_jax_tree(tree).items()}

    return AdamWState(
        mu=moments(state.mu), nu=moments(state.nu),
        count=_to_tensor(np.asarray(state.count, dtype=np.int32), device))


# ---------------------------------------------------------------------------
# The CNN: a list of per-block dicts, HWIO <-> OIHW convolution weights.
# ---------------------------------------------------------------------------
def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1))) \
        if a.ndim == 4 else a


def _oihw_to_hwio(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0))) \
        if a.ndim == 4 else a


def cnn_named_arrays(tree: dict) -> dict:
    """A JAX CNN tree (``stem``, ``blocks`` list, ``head``) of numpy arrays
    -> {port parameter name: array in the port's orientation}."""
    named = {}
    for part in ("stem", "head"):
        for key, a in tree[part].items():
            named[f"{part}.{key}"] = _hwio_to_oihw(np.asarray(a))
    for i, bp in enumerate(tree["blocks"]):
        for key, a in bp.items():
            named[f"blocks.{i}.{key}"] = _hwio_to_oihw(np.asarray(a))
    return named


def load_cnn_params(tree: dict, *, device="cuda") -> dict:
    """JAX CNN param tree of numpy arrays -> the port's {name: tensor}."""
    return {n: _to_tensor(a, device)
            for n, a in cnn_named_arrays(tree).items()}


def export_cnn_params(named: dict) -> dict:
    """The reverse of :func:`load_cnn_params` (and of
    :func:`cnn_named_arrays`): {port name: tensor or array} -> a JAX CNN
    tree of numpy arrays."""
    tree: dict = {"stem": {}, "head": {}}
    blocks: dict = {}
    for name, x in named.items():
        arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
        arr = _oihw_to_hwio(arr)
        parts = name.split(".")
        if parts[0] == "blocks":
            blocks.setdefault(int(parts[1]), {})[parts[2]] = arr
        else:
            tree[parts[0]][parts[1]] = arr
    tree["blocks"] = [blocks[i] for i in range(len(blocks))]
    return tree


def export_cnn_opt_state(state: AdamWState) -> AdamWState:
    """The port's CNN AdamW state -> the JAX layout (numpy)."""
    return AdamWState(mu=export_cnn_params(state.mu),
                      nu=export_cnn_params(state.nu),
                      count=np.asarray(state.count.cpu().numpy(),
                                       dtype=np.int32))


def load_cnn_opt_state(state, *, device="cuda") -> AdamWState:
    """A JAX-layout CNN AdamW state (``mu``, ``nu``, ``count``) -> the
    port's, on ``device``."""
    return AdamWState(
        mu={n: _to_tensor(a, device)
            for n, a in cnn_named_arrays(state.mu).items()},
        nu={n: _to_tensor(a, device)
            for n, a in cnn_named_arrays(state.nu).items()},
        count=_to_tensor(np.asarray(state.count, dtype=np.int32), device))
