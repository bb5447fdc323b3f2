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
"""
from __future__ import annotations

import math

import torch


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
