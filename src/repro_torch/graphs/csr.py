"""Graph container: CSR + COO edge arrays (paper §3.1).

Algorithms here are *edge-centric*: one vectorized pass over the edge
arrays generates the round's atomic active messages (src active ->
message to dst).  :func:`partition_edges` splits the edges over the
shards of the wave engine.  ``GraphSet`` of the reference comes with the
graph-batch entry points.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass
class Graph:
    """CSR + COO on one device. ``src``/``dst`` are edge-parallel arrays
    sorted by src."""
    indptr: torch.Tensor         # int32 [V+1]
    src: torch.Tensor            # int32 [E]
    dst: torch.Tensor            # int32 [E]
    weights: torch.Tensor        # float32 [E]
    num_vertices: int
    num_edges: int

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def out_degree(self, v) -> torch.Tensor:
        return self.indptr[v + 1] - self.indptr[v]

    @property
    def avg_degree(self) -> float:
        return self.num_edges / max(self.num_vertices, 1)


def from_edges(src: np.ndarray, dst: np.ndarray, num_vertices: int,
               weights: np.ndarray | None = None, *,
               symmetrize: bool = False, dedupe: bool = True,
               device="cuda") -> Graph:
    """Graph on ``device`` from host edge lists: self-loops dropped,
    optionally symmetrized and de-duplicated, sorted by source."""
    device = resolve_device(device)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if weights is None:
        weights = np.ones(src.shape, np.float32)
    keep = src != dst                       # drop self-loops
    src, dst, weights = src[keep], dst[keep], weights[keep]
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        weights = np.concatenate([weights, weights])
    if dedupe and len(src):
        key = src * num_vertices + dst
        _, idx = np.unique(key, return_index=True)
        src, dst, weights = src[idx], dst[idx], weights[idx]
    order = np.argsort(src, kind="stable")
    src, dst, weights = src[order], dst[order], weights[order]
    indptr = np.cumsum(np.bincount(src + 1, minlength=num_vertices + 1))
    return graph_on(indptr, src, dst, weights, num_vertices, device)


def graph_on(indptr, src, dst, weights, num_vertices: int, device) -> Graph:
    """Graph on ``device`` from host CSR/COO arrays (no validation)."""
    def put(a, dtype):
        a = np.ascontiguousarray(a, dtype)
        if not a.flags.writeable:      # e.g. a view of another framework's
            a = a.copy()               # buffer: the tensor must own its data
        return torch.from_numpy(a).to(device)
    src = put(src, np.int32)
    return Graph(indptr=put(indptr, np.int32), src=src,
                 dst=put(dst, np.int32), weights=put(weights, np.float32),
                 num_vertices=int(num_vertices), num_edges=int(src.shape[0]))


# ---------------------------------------------------------------------------
# 1-D partitioning (paper §3.1: V split into contiguous owner ranges)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Partition:
    num_shards: int
    block: int          # vertices per shard (padded)

    def owner(self, v):
        return v // self.block

    def local(self, v):
        return v % self.block


def partition_tensors(g: Graph, num_shards: int):
    """:func:`partition_edges` as tensors on ``g``'s device: (src, dst, w,
    valid, eid), each [num_shards, E_max], + Partition.  A shard's slots
    hold its edges in their original order, as the reference's boolean
    selection leaves them."""
    v, e, dev = g.num_vertices, g.num_edges, g.device
    block = -(-v // num_shards)
    owner = (g.src // block).long()
    counts = torch.bincount(owner, minlength=num_shards)
    emax = max(int(counts.max()), 1)
    order = torch.argsort(owner, stable=True)
    row = owner[order]
    slot = torch.arange(e, device=dev) - (torch.cumsum(counts, 0)
                                          - counts)[row]

    def lay(a, fill, dtype):
        out = torch.full((num_shards, emax), fill, dtype=dtype, device=dev)
        out[row, slot] = a[order].to(dtype)
        return out
    return (lay(g.src, 0, torch.int32), lay(g.dst, 0, torch.int32),
            lay(g.weights, 0, torch.float32),
            lay(torch.ones(e, dtype=torch.bool, device=dev), False,
                torch.bool),
            lay(torch.arange(e, device=dev), e, torch.int32)), \
        Partition(num_shards, block)


def partition_edges(g: Graph, num_shards: int):
    """Split edges by owner of the source (each shard expands its own
    vertices), padded to equal length.  Returns numpy arrays shaped
    [num_shards, E_max]: (src, dst, w, valid, eid) + Partition.

    ``eid`` carries each slot's original edge index (``num_edges`` in
    padding slots).  The arrays equal the reference's
    (``repro.graphs.csr.partition_edges``) for the same graph."""
    arrays, part = partition_tensors(g, num_shards)
    return tuple(a.cpu().numpy() for a in arrays), part
