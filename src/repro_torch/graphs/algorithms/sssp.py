"""SSSP (Bellman-Ford label-correcting) — FF&MF messages, weighted ``min``
commit.  Same AAM structure as BFS with ``dist[src] + w`` payloads."""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.core import autotune as AT
from repro_torch.core import commit as C
from repro_torch.core.messages import make_messages
from repro_torch.graphs.csr import Graph

INF = 3.0e38


def sssp(g: Graph, source: int, *, commit: str = "coarse",
         m: int | None = None, sort: bool = True,
         spec: C.CommitSpec | None = None):
    """Returns ``(dist [V] float32, rounds)`` on ``g``'s device."""
    if spec is None:
        spec = C.CommitSpec(backend=commit, m=m, sort=sort, stats=False)
    v = g.num_vertices
    dist = torch.full((v,), INF, dtype=torch.float32, device=g.device)
    dist[source] = 0.0
    frontier = torch.zeros((v,), dtype=torch.bool, device=g.device)
    frontier[source] = True
    step, lvl = AT.make_commit_step(spec, "min", dist)
    rounds = 0
    while rounds < v and bool(frontier.any()):
        active = frontier[g.src]
        msgs = make_messages(g.dst, dist[g.src] + g.weights, active)
        res, lvl = step(dist, msgs, lvl)
        frontier = res.state != dist
        dist = res.state
        rounds += 1
    return dist, rounds


def sssp_reference(g: Graph, source: int):
    """Dijkstra oracle (tests)."""
    indptr = g.indptr.cpu().numpy()
    dst = g.dst.cpu().numpy()
    w = g.weights.cpu().numpy()
    dist = np.full(g.num_vertices, np.inf)
    dist[source] = 0.0
    pq = [(0.0, source)]
    while pq:
        du, u = heapq.heappop(pq)
        if du > dist[u]:
            continue
        for e in range(indptr[u], indptr[u + 1]):
            nd = du + w[e]
            if nd < dist[dst[e]]:
                dist[dst[e]] = nd
                heapq.heappush(pq, (nd, int(dst[e])))
    return dist
