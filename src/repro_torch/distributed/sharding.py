"""Sharding rules: parameter, activation and cache specs (counterpart of
``repro.distributed.sharding``).

Mesh axes: ``("pod", "data", "model")`` multi-pod or ``("data",
"model")`` single-pod (``launch/mesh.py`` :class:`Mesh`).  DP runs over
(pod, data); TP over model.  Rules are name-based over the parameter
names:

  * last-dim "model"      : wq wk wv w_gate w_up q_b kv_b w1 b1 shared_*
                            lm_head
  * penultimate "model"   : wo w_down w2 shared_down embed
  * MoE EP mode           : experts sharded on the expert axis instead
  * SSM params            : replicated

Caches shard batch over DP when divisible, KV heads over model when
divisible, otherwise the sequence dim over model (long-context serving).

A spec is a tuple with one entry a dim: ``None`` (replicated), an axis
name, or a tuple of axis names (the dim split over all of them, in
order) -- the entries of a ``PartitionSpec``; ``()`` replicates the whole
tensor.  :func:`to_placements` turns one into DTensor placements over a
``DeviceMesh``.

The port's parameters are per layer, ``blocks.<i>.<path>``
(``models/bridge.py``), where the reference stacks each block leaf along
a leading layer axis.  So a block leaf's spec here is the reference's
without its leading (always replicated) layer entry, and the
expert-parallel rule tests 3 dims where the reference tests 4.  The
caches keep the stacked ``(L, B, Hkv, S, hd)`` layout on both sides, so
their specs are the reference's entry for entry.
"""
from __future__ import annotations

from typing import Mapping

from repro_torch.launch.mesh import Mesh

_LAST = {"wq", "wk", "wv", "w_gate", "w_up", "q_b", "kv_b", "w1", "b1",
         "shared_gate", "shared_up", "lm_head"}
_PENULT = {"wo", "w_down", "w2", "shared_down", "embed"}

Spec = tuple


def dp_axes(mesh: Mesh):
    # a bare axis name (not a 1-tuple), as the reference's entries are
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def dp_size(mesh: Mesh) -> int:
    axes = dp_axes(mesh)
    s = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        s *= mesh.shape[a]
    return s


def _names(name: str) -> list[str]:
    """A dotted parameter or cache name without its layer indices."""
    return [p for p in name.split(".") if not p.isdigit()]


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", leaf))


def param_specs(cfg, params: Mapping, mesh: Mesh | None = None) -> dict:
    """``{name: spec}`` for ``params`` (``{name: tensor or shape}``, the
    names of ``Module.named_parameters``).

    With ``mesh``, any dim the rule would put on "model" but whose size
    does not divide ``mesh.shape["model"]`` falls back to replicated for
    that leaf, so the same table serves every mesh.  Without ``mesh`` the
    raw (production) rules are returned."""
    ep = cfg is not None and cfg.moe is not None \
        and cfg.moe.expert_mode == "ep"
    n_model = None
    if mesh is not None:
        n_model = mesh.shape["model"] if "model" in mesh.axis_names else 1

    def fit(spec: Spec, shape) -> Spec:
        if n_model is None:
            return spec
        return tuple(None if name == "model"
                     and (n_model == 1 or shape[ax] % n_model) else name
                     for ax, name in enumerate(spec))

    def spec_for(full_name, leaf) -> Spec:
        names = _names(full_name)
        name = names[-1]
        shape = _shape(leaf)
        nd = len(shape)
        if "ssm" in names:
            return ()
        if ep and name in ("w_gate", "w_up", "w_down") and nd == 3:
            return fit(("model", None, None), shape)
        if name in _LAST and nd >= 1:
            return fit((None,) * (nd - 1) + ("model",), shape)
        if name in _PENULT and nd >= 2:
            return fit((None,) * (nd - 2) + ("model", None), shape)
        return ()

    return {n: spec_for(n, leaf) for n, leaf in params.items()}


def flash_shard_specs(mesh: Mesh | None, batch: int, heads: int,
                      kv_heads: int) -> Spec | None:
    """The spec that shards the flash op's (B, H|Hkv, S, D) q / k / v /
    o, or None.  Batch over DP, heads over "model"; head sharding needs
    both head counts to divide the model axis, so every GQA group stays
    on one shard.  None means the mesh cannot split the call cleanly (or
    is trivial) and the caller dispatches unsharded."""
    if mesh is None or "model" not in mesh.axis_names:
        return None
    n_model = mesh.shape["model"]
    dp = dp_axes(mesh)
    n_dp = dp_size(mesh)
    b_ax = dp if (n_dp > 1 and batch % n_dp == 0) else None
    h_ax = "model" if (n_model > 1 and heads % n_model == 0
                       and kv_heads % n_model == 0) else None
    if b_ax is None and h_ax is None:
        return None
    return (b_ax, h_ax, None, None)


def serve_kv_shard(mesh: Mesh | None, kv_heads: int, s: int) -> str:
    """How the serve pool's (B, Hkv, S, hd) cache shards under ``mesh``:
    "heads" (KV heads over "model"), "seq" (the sequence over "model",
    merged by a flash-style combine) or "none".  The slot axis never
    shards: DP in serving is separate engine replicas."""
    if mesh is None or "model" not in mesh.axis_names:
        return "none"
    n_model = mesh.shape["model"]
    if n_model == 1:
        return "none"
    if kv_heads % n_model == 0:
        return "heads"
    if s % n_model == 0:
        return "seq"
    return "none"


def serve_cache_specs(cfg, cache: Mapping, mesh: Mesh) -> dict:
    """Slot-pool cache specs for the continuous-batching engine, per
    :func:`serve_kv_shard`; leaves the engine does not shard (``pos``,
    SSM / conv state) are replicated."""

    def spec_for(full_name, leaf) -> Spec:
        name = _names(full_name)[-1]
        shape = _shape(leaf)
        if name in ("k", "v") and len(shape) == 5:       # (L, B, Hkv, S, hd)
            mode = serve_kv_shard(mesh, shape[2], shape[3])
            if mode == "heads":
                return (None, None, "model", None, None)
            if mode == "seq":
                return (None, None, None, "model", None)
        if name in ("k_scale", "v_scale") and len(shape) == 4:  # (L,B,Hkv,S)
            mode = serve_kv_shard(mesh, shape[2], shape[3])
            if mode == "heads":
                return (None, None, "model", None)
            if mode == "seq":
                return (None, None, None, "model")
        return ()

    return {n: spec_for(n, leaf) for n, leaf in cache.items()}


def spec_shards(mesh: Mesh, spec: Spec) -> int:
    """Number of devices a spec splits one tensor across."""
    n = 1
    for entry in spec:
        if entry is None:
            continue
        for ax in ((entry,) if isinstance(entry, str) else entry):
            n *= mesh.shape[ax]
    return n


def batch_specs(cfg, batch: Mapping, mesh: Mesh) -> dict:
    """Input-batch specs: the leading batch dim over DP (M-RoPE's (3, B,
    S) positions: dim 1)."""
    dp = dp_axes(mesh)

    def spec_for(full_name, leaf) -> Spec:
        nd = len(_shape(leaf))
        if _names(full_name)[-1] == "positions" and nd == 3:
            return (None, dp, None)
        return (dp,) + (None,) * (nd - 1)

    return {n: spec_for(n, leaf) for n, leaf in batch.items()}


def cache_specs(cfg, cache: Mapping, mesh: Mesh) -> dict:
    """Decode-cache specs (see the module docstring for the policy)."""
    dp = dp_axes(mesh)
    n_dp = dp_size(mesh)
    n_model = mesh.shape["model"]

    def seq_entry(b_ax, s):
        seq_ax = ("data", "model") if b_ax is None else "model"
        n_seq = n_model if b_ax is not None else (
            n_dp * n_model // mesh.shape.get("pod", 1))
        return None if s % n_seq else seq_ax   # rolling windows stay local

    def spec_for(full_name, leaf) -> Spec:
        name = _names(full_name)[-1]
        shape = _shape(leaf)
        if name == "pos":
            return ()
        b = shape[1] if len(shape) > 1 else 0
        b_ax = dp if (b and b % n_dp == 0) else None
        if name in ("k", "v", "gk", "gv", "wk", "wv"):   # (L, B, Hkv, S, hd)
            hkv, s = shape[2], shape[3]
            if hkv % n_model == 0:
                return (None, b_ax, "model", None, None)
            return (None, b_ax, None, seq_entry(b_ax, s), None)
        if name in ("k_scale", "v_scale", "gk_scale", "gv_scale",
                    "wk_scale", "wv_scale"):             # (L, B, Hkv, S)
            hkv, s = shape[2], shape[3]
            if hkv % n_model == 0:
                return (None, b_ax, "model", None)
            return (None, b_ax, None, seq_entry(b_ax, s))
        if name in ("mla_lat", "mla_rope"):              # (L, B, S, r)
            seq_ax = ("data", "model") if b_ax is None else "model"
            return (None, b_ax, seq_ax, None)
        if name in ("ssm", "conv"):                      # small states: DP
            return (None, b_ax)
        return ()

    return {n: spec_for(n, leaf) for n, leaf in cache.items()}


def _block(mesh: Mesh, entry, where: Mapping[str, int]) -> tuple[int, int]:
    """(index, count) of the block a spec entry gives the rank at
    ``where`` (its coordinates, ``launch/mesh.py`` ``coords``): the axes of
    a tuple entry split the dim in order, the first outermost."""
    idx, n = 0, 1
    for ax in (() if entry is None else
               (entry,) if isinstance(entry, str) else entry):
        idx = idx * mesh.shape[ax] + where[ax]
        n *= mesh.shape[ax]
    return idx, n


def local_shape(shape, spec: Spec, mesh: Mesh) -> tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` tensor under
    ``spec``; every split dim must divide."""
    out = []
    for d, size in enumerate(_shape(shape)):
        n = _block(mesh, spec[d] if d < len(spec) else None,
                   {a: 0 for a in mesh.axis_names})[1]
        if size % n:
            raise ValueError(f"spec {spec} splits dim {d} of {size} "
                             f"{n} ways")
        out.append(size // n)
    return tuple(out)


def shard_leaf(x, spec: Spec, mesh: Mesh, where: Mapping[str, int]):
    """The block of ``x`` (a tensor or a numpy array) that the rank at
    ``where`` holds under ``spec``, contiguous blocks in rank order (the
    ``Shard(d)`` placement of :func:`to_placements`).  A tensor's block is
    a copy, so the whole leaf can be freed; a replicated leaf is returned
    as it is."""
    idx = []
    for d, size in enumerate(local_shape(x.shape, spec, mesh)):
        i, _ = _block(mesh, spec[d] if d < len(spec) else None, where)
        idx.append(slice(i * size, (i + 1) * size))
    if all(sl.start == 0 and sl.stop == n
           for sl, n in zip(idx, x.shape)):
        return x
    block = x[tuple(idx)]
    return block.clone() if hasattr(block, "clone") else block.copy()


def to_placements(device_mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` over ``device_mesh`` (whose
    ``mesh_dim_names`` are the spec's axis names): ``Shard(d)`` on each
    mesh dim that splits tensor dim ``d``, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, entry in enumerate(spec):
        for ax in (() if entry is None else
                   (entry,) if isinstance(entry, str) else entry):
            dim_of[ax] = d
    unknown = set(dim_of) - set(device_mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} the "
                         f"mesh {device_mesh.mesh_dim_names} lacks")
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in device_mesh.mesh_dim_names)
