"""Graph container: CSR + COO edge arrays (paper §3.1).

Algorithms here are *edge-centric*: one vectorized pass over the edge
arrays generates the round's atomic active messages (src active ->
message to dst).  :func:`partition_edges` splits the edges over the
shards of the wave engine.  :class:`GraphSet` stacks G tenant graphs into
one flat vertex/edge space: the graph batch axis.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.coalescing import GraphBatch


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
# GraphSet: G tenant graphs stacked into one flat vertex/edge space
# ---------------------------------------------------------------------------


class GraphSet:
    """A batch of G independent graphs sharing one flat key space.

    Graph ``i``'s vertices occupy the contiguous range ``[voffs[i],
    voffs[i + 1])`` of the flat space, its edges the range ``[eoffs[i],
    eoffs[i + 1])`` of the stacked edge arrays.  :meth:`union` builds the
    disjoint-union :class:`Graph` on the members' device: running a wave
    algorithm over the union is running it on every member at once,
    because members exchange no messages and their flat ranges never
    collide in the commit key space.  Sizes and offsets are plain ints,
    and :attr:`axis` is the matching
    :class:`repro_torch.core.coalescing.GraphBatch`."""

    def __init__(self, graphs):
        self.graphs = tuple(graphs)
        if not self.graphs:
            raise ValueError("GraphSet needs at least one graph")
        devices = {g.device for g in self.graphs}
        if len(devices) != 1:
            raise ValueError(f"GraphSet members lie on several devices: "
                             f"{sorted(map(str, devices))}")
        self.vsizes = tuple(int(g.num_vertices) for g in self.graphs)
        self.esizes = tuple(int(g.num_edges) for g in self.graphs)
        self.voffs = np.concatenate(
            [[0], np.cumsum(self.vsizes)]).astype(np.int64)
        self.eoffs = np.concatenate(
            [[0], np.cumsum(self.esizes)]).astype(np.int64)
        self._union: Graph | None = None

    @property
    def device(self) -> torch.device:
        return self.graphs[0].device

    @property
    def num_graphs(self) -> int:
        return len(self.graphs)

    @property
    def num_vertices(self) -> int:
        return int(self.voffs[-1])

    @property
    def num_edges(self) -> int:
        return int(self.eoffs[-1])

    def vertex_offset(self, i: int) -> int:
        return int(self.voffs[i])

    @property
    def axis(self) -> GraphBatch:
        """The graph batch axis of this set."""
        return GraphBatch(sizes=self.vsizes)

    def union(self) -> Graph:
        """The disjoint-union graph (cached): stacked edge arrays with
        each member's vertex offset added, concatenated CSR indptr."""
        if self._union is None:
            offs = [int(o) for o in self.voffs[:-1]]
            eoffs = [int(o) for o in self.eoffs[:-1]]
            src = torch.cat([g.src + o for g, o in zip(self.graphs, offs)])
            dst = torch.cat([g.dst + o for g, o in zip(self.graphs, offs)])
            w = torch.cat([g.weights for g in self.graphs])
            indptr = torch.cat(
                [g.indptr[:-1] + o for g, o in zip(self.graphs, eoffs)]
                + [torch.tensor([self.num_edges], dtype=torch.int32,
                                device=self.device)])
            self._union = Graph(indptr=indptr, src=src, dst=dst, weights=w,
                                num_vertices=self.num_vertices,
                                num_edges=self.num_edges)
        return self._union

    def flat_vertices(self, per_graph) -> torch.Tensor:
        """Map per-graph vertex ids ``per_graph`` ([G] int) into the flat
        space: ``voffs[i] + per_graph[i]``, int32 on the set's device."""
        ids = np.asarray(torch.as_tensor(per_graph).cpu(), np.int64)
        if ids.shape != (self.num_graphs,):
            raise ValueError(f"expected one vertex per graph "
                             f"({self.num_graphs}), got shape {ids.shape}")
        return torch.as_tensor(self.voffs[:-1] + ids, dtype=torch.int32,
                               device=self.device)

    def split_vertex(self, flat) -> list:
        """Slice a flat [num_vertices] (or [num_vertices, ...]) array back
        into per-graph rows."""
        return [flat[int(self.voffs[i]):int(self.voffs[i + 1])]
                for i in range(self.num_graphs)]

    def split_edge(self, flat) -> list:
        return [flat[int(self.eoffs[i]):int(self.eoffs[i + 1])]
                for i in range(self.num_graphs)]

    def graph_of_vertex(self) -> torch.Tensor:
        """int32 [num_vertices] graph index per flat vertex id."""
        return self._repeat(self.vsizes)

    def graph_of_edge(self) -> torch.Tensor:
        """int32 [num_edges] graph index per stacked edge id."""
        return self._repeat(self.esizes)

    def _repeat(self, sizes) -> torch.Tensor:
        return torch.repeat_interleave(
            torch.arange(self.num_graphs, dtype=torch.int32,
                         device=self.device),
            torch.as_tensor(sizes, dtype=torch.int64, device=self.device))


def segment_sum(values, seg, num_segments: int) -> torch.Tensor:
    """[num_segments, ...] sums of ``values`` [n, ...] by segment id
    ``seg`` [n] (a GraphSet's per-graph reductions by its
    graph-of-vertex map)."""
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg.long(), values)


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
