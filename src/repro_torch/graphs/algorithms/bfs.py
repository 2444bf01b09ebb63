"""BFS — FF&MF atomic active messages (paper §3.3.2, Listing 4).

Label-correcting edge-centric formulation: every round, each edge whose
source is in the frontier emits a message ``(dst, dist[src]+1)``; messages
commit with the MF ``min`` operator (losers fail silently); the next
frontier is the set of vertices whose distance changed.  The round loop
runs on the host and reads one flag per round.  The multi-source, graph
batch and distributed forms come with the batch axes and the engine.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.core import autotune as AT
from repro_torch.core import commit as C
from repro_torch.core.messages import make_messages
from repro_torch.graphs.csr import Graph

INF = 2 ** 30


@dataclasses.dataclass
class BfsResult:
    dist: torch.Tensor
    rounds: int
    messages: torch.Tensor
    conflicts: torch.Tensor
    applied: torch.Tensor


def bfs(g: Graph, source: int, *, commit: str = "coarse", m: int | None = None,
        sort: bool = True, spec: C.CommitSpec | None = None) -> BfsResult:
    """BFS from ``source`` on ``g``'s device.  ``spec`` names the commit
    backend directly; the legacy ``commit``/``m``/``sort`` knobs build one
    when it is omitted."""
    if spec is None:
        spec = C.CommitSpec(backend=commit, m=m, sort=sort, stats=False)
    v = g.num_vertices
    dist = torch.full((v,), INF, dtype=torch.int32, device=g.device)
    dist[source] = 0
    frontier = torch.zeros((v,), dtype=torch.bool, device=g.device)
    frontier[source] = True
    step, lvl = AT.make_commit_step(spec, "min", dist)
    zero = torch.zeros((), dtype=torch.int64, device=g.device)
    nmsg, ncf, nap = zero, zero, zero
    rounds = 0
    while rounds < v and bool(frontier.any()):
        active = frontier[g.src]
        msgs = make_messages(g.dst, dist[g.src] + 1, active)
        res, lvl = step(dist, msgs, lvl)
        frontier = res.state != dist
        dist = res.state
        rounds += 1
        nmsg = nmsg + active.sum()
        ncf = ncf + res.conflicts
        nap = nap + res.applied
    return BfsResult(dist, rounds, nmsg, ncf, nap)


def bfs_reference(g: Graph, source: int):
    """Pure-python BFS oracle (tests)."""
    indptr = g.indptr.cpu().numpy()
    dst = g.dst.cpu().numpy()
    dist = np.full(g.num_vertices, 2 ** 30, np.int64)
    dist[source] = 0
    q = collections.deque([source])
    while q:
        u = q.popleft()
        for e in range(indptr[u], indptr[u + 1]):
            w_ = dst[e]
            if dist[w_] > dist[u] + 1:
                dist[w_] = dist[u] + 1
                q.append(w_)
    return dist
