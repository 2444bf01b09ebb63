"""PageRank — FF&AS atomic active messages (paper §3.3.1, Listing 3).

Every edge carries ``d * rank[src] / out_deg[src]`` to its destination;
the commit is an Always-Succeed accumulate.  :func:`distributed_pagerank`
runs on the wave engine; the multi-source and graph-batch forms come
later (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import autotune as AT
from repro_torch.core import commit as C
from repro_torch.core.engine import (AlgorithmSpec, run_distributed,
                                     telemetry_return)
from repro_torch.core.messages import make_messages
from repro_torch.graphs.csr import Graph


def _run(g: Graph, rank, update, *, d: float, iters: int,
         spec: C.CommitSpec):
    """The shared iteration: accumulate messages, then
    ``rank = update(dangling mass, accumulated)``."""
    deg = g.degrees.clamp(min=1).to(torch.float32)
    dangling = g.degrees == 0
    acc0 = torch.zeros((g.num_vertices,), dtype=torch.float32,
                       device=g.device)
    ones = torch.ones_like(g.src, dtype=torch.bool)
    step, lvl = AT.make_commit_step(spec, "add", acc0)
    conflicts = torch.zeros((), dtype=torch.int64, device=g.device)
    for _ in range(iters):
        contrib = d * rank[g.src] / deg[g.src]
        res, lvl = step(acc0, make_messages(g.dst, contrib, ones), lvl)
        dangle = torch.where(dangling, rank, 0.0).sum()
        rank = update(dangle, res.state)
        conflicts = conflicts + res.conflicts
    return rank, conflicts


def pagerank(g: Graph, *, d: float = 0.85, iters: int = 20,
             commit: str = "coarse", m: int | None = None, sort: bool = True,
             spec: C.CommitSpec | None = None):
    """Returns ``(rank [V] float32, conflicts)``; dangling mass spreads
    over every vertex."""
    if spec is None:
        spec = C.CommitSpec(backend=commit, m=m, sort=sort, stats=False)
    v = g.num_vertices
    rank0 = torch.full((v,), 1.0 / v, dtype=torch.float32, device=g.device)
    return _run(g, rank0, lambda dm, acc: (1.0 - d) / v + acc + d * dm / v,
                d=d, iters=iters, spec=spec)


def personalized_pagerank(g: Graph, source: int, *, d: float = 0.85,
                          iters: int = 20, commit: str = "coarse",
                          m: int | None = None, sort: bool = True,
                          spec: C.CommitSpec | None = None):
    """Personalized PageRank: the random surfer teleports home to
    ``source``, and dangling mass returns there too, so mass stays 1."""
    if spec is None:
        spec = C.CommitSpec(backend=commit, m=m, sort=sort, stats=False)
    restart = torch.zeros((g.num_vertices,), dtype=torch.float32,
                          device=g.device)
    restart[source] = 1.0
    return _run(g, restart,
                lambda dm, acc: restart * ((1.0 - d) + d * dm) + acc,
                d=d, iters=iters, spec=spec)


def distributed_pagerank(mesh, g: Graph, *, iters: int = 20,
                         capacity: int | str = 4096, m: int | None = None,
                         axis: str = "data", d: float = 0.85,
                         spec: C.CommitSpec | None = None,
                         max_subrounds: int = 64, telemetry: bool = False):
    """PageRank over a mesh axis: FF&AS accumulate waves on the wave
    engine, the dangling mass psum'd over ranks.  Returns rank [V];
    ``telemetry=True`` returns (rank, DistributedResult)."""
    v = g.num_vertices
    dev = mesh.device

    def init(g, layout):
        vpad = layout.vpad
        real = torch.zeros((vpad,), dtype=torch.bool, device=dev)
        real[:v] = True
        deg = torch.zeros((vpad,), dtype=torch.int32, device=dev)
        deg[:v] = g.degrees.clamp(min=1).to(dev)
        dangling = torch.zeros((vpad,), dtype=torch.bool, device=dev)
        dangling[:v] = (g.degrees == 0).to(dev)
        state = {"rank": torch.where(real, 1.0 / v, 0.0).to(torch.float32),
                 "deg": deg, "dangling": dangling, "real": real}
        return state, {}

    def round_fn(rt, e, st, sc, it):
        rank = st["rank"]
        contrib = d * rank[e.my_src] / st["deg"][e.my_src].to(torch.float32)
        acc, _ = rt.wave(torch.zeros_like(rank), e.dst, contrib, e.valid,
                         op="add")
        dm = rt.psum(torch.where(st["dangling"], rank, 0.0).sum())
        rank = torch.where(st["real"], (1.0 - d) / v + acc + d * dm / v, 0.0)
        return dict(st, rank=rank), sc, True

    alg = AlgorithmSpec("pagerank", "FF&AS", init, round_fn,
                        lambda g, layout: iters)
    res = run_distributed(alg, mesh, g, capacity=capacity, m=m, axis=axis,
                          spec=spec, max_subrounds=max_subrounds)
    rank = res.state["rank"][:v]
    return telemetry_return(rank, res, telemetry)


def pagerank_reference(g: Graph, d=0.85, iters=20):
    """NumPy oracle."""
    v = g.num_vertices
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    indptr = g.indptr.cpu().numpy()
    deg = np.maximum(indptr[1:] - indptr[:-1], 1)
    dangling = (indptr[1:] - indptr[:-1]) == 0
    rank = np.full(v, 1.0 / v)
    for _ in range(iters):
        acc = np.zeros(v)
        np.add.at(acc, dst, d * rank[src] / deg[src])
        acc += d * rank[dangling].sum() / v
        rank = (1 - d) / v + acc
    return rank
