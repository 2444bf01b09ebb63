"""Meshes: the wave engine's handle and the parallel layouts'
``DeviceMesh``es.

A :class:`Mesh` names one axis of ``size`` shards, this process's
``rank`` on it, the ``torch.distributed`` process group that joins them
and the device this rank computes on.  ``mesh.shape[axis]`` reads as in
the reference's ``jax.sharding.Mesh``.  With ``group=None`` the mesh is
one shard and the engine runs no collective.  :func:`sub_mesh` is the
surviving mesh of degraded-mesh mode.  :func:`spawn_ranks` runs a
function on a :class:`Mesh` of ``world`` gloo processes on one device,
the port's form of the reference's forced host devices
(``--xla_force_host_platform_device_count``).

:func:`make_production_mesh` and :func:`make_host_mesh` (port of
``repro.launch.mesh``) return ``torch.distributed.device_mesh.
DeviceMesh``es with the reference's shapes and dim names, over the group
``init_process_group`` started: 16 x 16 ``("data", "model")``, 2 x 16 x
16 ``("pod", "data", "model")`` with ``multi_pod``.  They are functions,
so importing this module touches no process group.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

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


def _rank_main(rank, world, store_path, device, fn, args):
    import torch.distributed as dist
    torch.set_num_threads(1)          # the ranks share the host's cores
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        fn(make_mesh(group=dist.group.WORLD, device=device), *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, *, device="cuda", args=(),
                timeout_s: float | None = None) -> None:
    """Run ``fn(mesh, *args)`` on ``world`` spawned processes, each rank
    of one gloo group over ``device`` (several ranks share one card; gloo
    takes their CUDA tensors through host memory), and return when every
    rank has.  ``fn`` and ``args`` must pickle (a module-level function).
    On a card the kernels are built here first, so the ranks only load
    them.  Raises when a rank raises, dies or outlives ``timeout_s``;
    the other ranks are killed."""
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        from repro_torch.kernels import _build
        _build.build()
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(world, os.path.join(tmp, "store"), str(device),
                              fn, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish in "
                                       f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)


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
