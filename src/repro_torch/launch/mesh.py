"""Mesh construction (counterpart of ``repro.launch.mesh``).

A :class:`Mesh` is a value: ordered axis names and their sizes, nothing
else.  It stands where the reference passes a ``jax.sharding.Mesh`` or an
``AbstractMesh`` to a rule (``distributed/sharding.py``, the planner, the
train step), so every rule is a plain function of ``(cfg, shapes,
mesh)`` that needs no devices and no process group.  :func:`device_mesh`
turns one into a ``torch.distributed`` ``DeviceMesh`` once a process
group exists.

``make_production_mesh`` is the reference's production shape, (data 16,
model 16), with a leading "pod" axis for cross-pod DP.  ``make_mesh_for``
supports elastic restarts: given however many ranks there are, it picks
the largest (data, model) grid with model <= ``max_model``, with the
reference's arithmetic, and a checkpoint restores into it.

Ranks lie on a mesh in row-major order, as ``init_device_mesh`` lays them
out: on (data, model) a model group is ``model`` contiguous ranks.
:func:`coords` is a rank's place on the mesh and :func:`axis_group` the
process group of this rank along one axis; a world of one rank with no
process group is the meshless path (no group, every coordinate 0).
:func:`init_distributed` joins the group torchrun's environment names.
"""
from __future__ import annotations

import math
import os

import torch

from repro_torch.core.device import resolve_device


class Mesh:
    """Ordered named axes and their sizes: ``Mesh(data=2, model=1)``,
    ``Mesh(pod=2, data=16, model=16)``."""

    __slots__ = ("_axes",)

    def __init__(self, **axes: int):
        if not axes:
            raise ValueError("a mesh needs at least one axis")
        for name, n in axes.items():
            if int(n) < 1:
                raise ValueError(f"mesh axis {name!r} has size {n}")
        object.__setattr__(self, "_axes",
                           tuple((a, int(n)) for a, n in axes.items()))

    def __setattr__(self, name, value):
        raise AttributeError("Mesh is immutable")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self._axes)

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(n for _, n in self._axes)

    @property
    def shape(self) -> dict[str, int]:
        return dict(self._axes)

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._axes == other._axes

    def __hash__(self):
        return hash(self._axes)

    def __repr__(self):
        return "Mesh(" + ", ".join(f"{a}={n}" for a, n in self._axes) + ")"


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    return Mesh(pod=2, data=16, model=16) if multi_pod \
        else Mesh(data=16, model=16)


def make_mesh_for(n_devices: int | None = None, *,
                  max_model: int = 16) -> Mesh:
    """Largest (data, model) mesh for an arbitrary rank count (elastic);
    ``n_devices`` defaults to the default process group's world size."""
    n = n_devices or world_size()
    model = math.gcd(n, max_model)
    while model > 1 and n % model:
        model //= 2
    return Mesh(data=n // model, model=model)


def describe(mesh: Mesh) -> str:
    return " x ".join(f"{a}={mesh.shape[a]}" for a in mesh.axis_names)


def device_mesh(mesh: Mesh, device_type: str):
    """The ``DeviceMesh`` of ``mesh`` over the default process group, with
    its axis names as ``mesh_dim_names``; the group must exist and hold
    exactly ``mesh.size`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    if world_size() != mesh.size or not torch.distributed.is_initialized():
        raise RuntimeError(
            f"device_mesh: {mesh} needs an initialized process group of "
            f"{mesh.size} ranks (world size {world_size()})")
    return init_device_mesh(device_type, mesh.sizes,
                            mesh_dim_names=mesh.axis_names)


def rank() -> int:
    """This process's rank in the default process group; 0 without one."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() \
        and dist.is_initialized() else 0


def coords(mesh: Mesh, of_rank: int | None = None) -> dict[str, int]:
    """``{axis: index}`` of ``of_rank`` (default: this process) on
    ``mesh``, ranks laid out row-major over the axes in order."""
    r = rank() if of_rank is None else of_rank
    if not 0 <= r < mesh.size:
        raise ValueError(f"rank {r} is not on {mesh}")
    out = {}
    for a, n in reversed(mesh._axes):
        out[a] = r % n
        r //= n
    return {a: out[a] for a in mesh.axis_names}


def axis_ranks(mesh: Mesh, axis: str) -> list[list[int]]:
    """Every group of ranks that differ only in their ``axis`` coordinate,
    in rank order: on (data 2, model 2), "model" gives [[0, 1], [2, 3]]
    and "data" [[0, 2], [1, 3]]."""
    groups: dict[tuple, list[int]] = {}
    for r in range(mesh.size):
        c = coords(mesh, r)
        key = tuple(c[a] for a in mesh.axis_names if a != axis)
        groups.setdefault(key, []).append(r)
    return [groups[k] for k in sorted(groups)]


_GROUPS: dict = {}


def axis_group(mesh: Mesh, axis: str):
    """The process group of this rank along ``axis`` of ``mesh``, or None
    where the axis has size 1 (nothing to communicate).  Every rank of the
    world must make the same calls in the same order the first time (it is
    collective: each group of the axis is created on every rank); the
    groups are kept for the process group's lifetime."""
    if mesh.shape.get(axis, 1) == 1:
        return None
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() != mesh.size:
        raise RuntimeError(
            f"axis_group: {mesh} needs an initialized process group of "
            f"{mesh.size} ranks (world size {world_size()})")
    key = (id(dist.group.WORLD), mesh, axis)
    if key not in _GROUPS:
        mine = None
        for ranks in axis_ranks(mesh, axis):
            g = dist.group.WORLD if len(ranks) == mesh.size \
                else dist.new_group(ranks)
            if rank() in ranks:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


def init_distributed(device_name: str):
    """-> (rank, world, device).  Under ``torchrun``'s environment, join
    the process group: NCCL on the card (this rank on ``cuda:LOCAL_RANK``),
    gloo on the CPU; nothing falls back to another backend.  Without it,
    one rank and no group."""
    dist = torch.distributed
    device = resolve_device(device_name)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 0, 1, device
    r, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    kw = {}
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://", world_size=world,
                            rank=r, **kw)
    return r, world, device
