"""Meshes: the wave engine's handle and the parallel layouts'
``DeviceMesh``es.

A :class:`Mesh` names one axis of ``size`` shards, this process's
``rank`` on it, the ``torch.distributed`` process group that joins them
and the device this rank computes on.  ``mesh.shape[axis]`` reads as in
the reference's ``jax.sharding.Mesh``.  With ``group=None`` the mesh is
one shard and the engine runs no collective.  :func:`sub_mesh` is the
surviving mesh of degraded-mesh mode.

:func:`make_production_mesh` and :func:`make_host_mesh` (port of
``repro.launch.mesh``) return ``torch.distributed.device_mesh.
DeviceMesh``es with the reference's shapes and dim names, over the group
``init_process_group`` started: 16 x 16 ``("data", "model")``, 2 x 16 x
16 ``("pod", "data", "model")`` with ``multi_pod``.  They are functions,
so importing this module touches no process group.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis: str
    size: int
    rank: int
    group: Any              # torch.distributed process group; None at size 1
    device: torch.device

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}


def make_mesh(*, axis: str = "data", group=None, device="cuda") -> Mesh:
    """A mesh over ``group`` (``torch.distributed.group.WORLD`` or a
    subgroup, after ``init_process_group``); ``group=None`` is world
    size 1.  Raises without a card when ``device`` names CUDA."""
    device = resolve_device(device)
    if group is None:
        return Mesh(axis, 1, 0, None, device)
    import torch.distributed as dist
    return Mesh(axis, dist.get_world_size(group), dist.get_rank(group),
                group, device)


def sub_mesh(mesh: Mesh, size: int) -> Mesh | None:
    """The mesh of the first ``size`` ranks of ``mesh``, for a rank among
    them, else None.  ``torch.distributed.new_group`` makes the group, so
    every process of the job calls this with the same ``size`` and in the
    same order; at ``size`` 1 no group is made and the one rank runs no
    collective."""
    if not 1 <= size <= mesh.size:
        raise ValueError(f"sub-mesh size {size} outside 1..{mesh.size}")
    if size == mesh.size:
        return mesh
    if size == 1:
        return Mesh(mesh.axis, 1, 0, None, mesh.device) if mesh.rank == 0 \
            else None
    import torch.distributed as dist
    ranks = dist.get_process_group_ranks(mesh.group)[:size]
    group = dist.new_group(ranks)
    if mesh.rank >= size:
        return None
    return Mesh(mesh.axis, size, mesh.rank, group, mesh.device)


def _device_mesh(shape: tuple, names: tuple, device):
    device = resolve_device(device)
    import torch.distributed as dist
    need = 1
    for n in shape:
        need *= n
    if not dist.is_initialized():
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs a "
                           f"process group of {need} ranks: call "
                           f"torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh {names} needs "
                         f"world size {need}; the process group has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh: 16 x 16 ``("data", "model")`` (256 ranks);
    with ``multi_pod`` a leading ``"pod"`` axis of 2 (512 ranks).  Raises
    when the process group's size differs, naming the size required."""
    if multi_pod:
        return _device_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return _device_mesh((16, 16), ("data", "model"), device)


def make_host_mesh(data: int = 1, model: int = 1, pod: int | None = None,
                   *, device="cuda"):
    """A small mesh (tests, one host): ``(data, model)``, or ``(pod,
    data, model)`` with ``pod``."""
    if pod is not None:
        return _device_mesh((pod, data, model), ("pod", "data", "model"),
                            device)
    return _device_mesh((data, model), ("data", "model"), device)
