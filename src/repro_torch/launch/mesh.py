"""The mesh handle of the wave engine.

A :class:`Mesh` names one axis of ``size`` shards, this process's
``rank`` on it, the ``torch.distributed`` process group that joins them
and the device this rank computes on.  ``mesh.shape[axis]`` reads as in
the reference's ``jax.sharding.Mesh``.  With ``group=None`` the mesh is
one shard and the engine runs no collective.
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
