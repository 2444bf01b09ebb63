"""Graph container: CSR + COO edge arrays (paper §3.1).

Algorithms here are *edge-centric*: one vectorized pass over the edge
arrays generates the round's atomic active messages (src active ->
message to dst).  ``GraphSet`` and ``Partition`` of the reference come
with the batch axes and the wave engine.
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
