"""The mesh handle of the wave engine.

A :class:`Mesh` names one axis of ``size`` shards, this process's
``rank`` on it, the ``torch.distributed`` process group that joins them
and the device this rank computes on.  ``mesh.shape[axis]`` reads as in
the reference's ``jax.sharding.Mesh``.  With ``group=None`` the mesh is
one shard and the engine runs no collective.  :func:`sub_mesh` is the
surviving mesh of degraded-mesh mode.
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
