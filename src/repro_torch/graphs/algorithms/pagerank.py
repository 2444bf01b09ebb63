"""PageRank — FF&AS atomic active messages (paper §3.3.1, Listing 3).

Every edge carries ``d * rank[src] / out_deg[src]`` to its destination;
the commit is an Always-Succeed accumulate.  :func:`multi_source_pagerank`
runs L personalized queries as lanes of one wave,
:func:`batched_over_graphs_pagerank` one query per tenant graph of a
:class:`~repro_torch.graphs.csr.GraphSet`, and the ``distributed_*`` forms
run on the wave engine.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import autotune as AT
from repro_torch.core import commit as C
from repro_torch.core.coalescing import QueryLanes
from repro_torch.core.engine import (AlgorithmSpec, run_distributed,
                                     telemetry_return)
from repro_torch.core.messages import lane_messages, make_messages
from repro_torch.graphs.csr import Graph, segment_sum


def _run(g: Graph, rank, update, *, d: float, iters: int,
         spec: C.CommitSpec):
    """The shared iteration: accumulate messages, then
    ``rank = update(dangling mass, accumulated)``."""
    deg = g.degrees.clamp(min=1).to(torch.float32)
    dangling = g.degrees == 0
    acc0 = torch.zeros((g.num_vertices,), dtype=torch.float32,
                       device=g.device)
    ones = torch.ones_like(g.src, dtype=torch.bool)
    step, lvl = AT.make_commit_step(spec, "add", acc0, n=g.num_edges)
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


def multi_source_pagerank(g: Graph, sources, *, d: float = 0.85,
                          iters: int = 20, commit: str = "coarse",
                          m: int | None = None, sort: bool = True,
                          spec: C.CommitSpec | None = None):
    """L personalized-PageRank queries as lanes of one fused wave.

    Returns (rank [L, V], conflicts).  Row l matches
    ``personalized_pagerank(g, sources[l])`` to float-add rounding (the
    composite-key commit reorders each lane's accumulate)."""
    if spec is None:
        spec = C.CommitSpec(backend=commit, m=m, sort=sort, stats=False)
    v, e, dev = g.num_vertices, g.num_edges, g.device
    sources = torch.as_tensor(sources, device=dev).long()
    lanes = sources.shape[0]
    deg = g.degrees.clamp(min=1).to(torch.float32)
    dangling = g.degrees == 0
    restart = torch.zeros((lanes, v), dtype=torch.float32, device=dev)
    restart[torch.arange(lanes, device=dev), sources] = 1.0
    dst_l = g.dst.expand(lanes, e)
    valid_l = torch.ones((lanes, e), dtype=torch.bool, device=dev)
    acc0 = torch.zeros((lanes * v,), dtype=torch.float32, device=dev)
    step, lvl = AT.make_commit_step(spec, "add", acc0, n=lanes * e,
                                    axis_width=lanes)
    conflicts = torch.zeros((), dtype=torch.int64, device=dev)
    rank = restart
    for _ in range(iters):
        contrib = d * rank[:, g.src] / deg[g.src][None, :]
        res, lvl = step(acc0, lane_messages(dst_l, contrib, valid_l, v), lvl)
        dangle = d * torch.where(dangling[None, :], rank, 0.0).sum(1)  # [L]
        rank = restart * ((1.0 - d) + dangle[:, None]) \
            + res.state.reshape(lanes, v)
        conflicts = conflicts + res.conflicts
    return rank, conflicts


def _union_ppr(g: Graph, sources_flat, gov, d, *, iters: int,
               spec: C.CommitSpec | None, num_graphs: int,
               axis_width: int):
    """Personalized PageRank over a disjoint-union graph with per-graph
    dangling mass (segment sums by ``gov``, the graph-of-vertex map)."""
    v, dev = g.num_vertices, g.device
    deg = g.degrees.clamp(min=1).to(torch.float32)
    dangling = g.degrees == 0
    restart = torch.zeros((v,), dtype=torch.float32, device=dev)
    restart[sources_flat.long()] = 1.0
    acc0 = torch.zeros((v,), dtype=torch.float32, device=dev)
    ones = torch.ones_like(g.src, dtype=torch.bool)
    step, lvl = AT.make_commit_step(spec, "add", acc0, n=g.num_edges,
                                    axis_width=axis_width)
    gov = gov.long()
    rank = restart
    for _ in range(iters):
        contrib = d * rank[g.src] / deg[g.src]
        res, lvl = step(acc0, make_messages(g.dst, contrib, ones), lvl)
        dm = segment_sum(torch.where(dangling, rank, 0.0), gov,
                         num_graphs)                                # [G]
        rank = restart * ((1.0 - d) + d * dm[gov]) + res.state
    return rank


def batched_over_graphs_pagerank(gs, sources, *, d: float = 0.85,
                                 iters: int = 20,
                                 spec: C.CommitSpec | None = None,
                                 mesh=None, capacity: int | str = 4096,
                                 axis: str = "data",
                                 max_subrounds: int = 64):
    """G personalized-PageRank queries, one per tenant graph, fused on the
    graph batch axis.  ``sources[g]`` is graph g's local restart vertex.
    Returns per-graph rank rows matching
    ``personalized_pagerank(gs.graphs[g], sources[g])`` to float-add
    rounding.  ``mesh=`` runs on the wave engine."""
    if spec is None:
        spec = C.CommitSpec(backend="coarse", stats=False)
    flat = gs.flat_vertices(sources)
    if mesh is not None:
        rank = _distributed_union_ppr(
            mesh, gs, flat, d=d, iters=iters, spec=spec,
            capacity=capacity, axis=axis, max_subrounds=max_subrounds)
    else:
        rank = _union_ppr(gs.union(), flat, gs.graph_of_vertex(), d,
                          iters=iters, spec=spec, num_graphs=gs.num_graphs,
                          axis_width=gs.num_graphs)
    return gs.split_vertex(rank)


def _distributed_union_ppr(mesh, gs, sources_flat, *, d, iters, spec,
                           capacity, axis, max_subrounds):
    """Graph-batched personalized PageRank on the wave engine: FF&AS
    accumulate waves over the union's flat owner slices, per-graph
    dangling mass psum'd as a [G] vector."""
    dev = mesh.device
    v = gs.num_vertices
    num_graphs = gs.num_graphs
    gov_v = gs.graph_of_vertex().to(dev)

    def init(g, layout):
        vpad = layout.vpad
        restart = torch.zeros((vpad,), dtype=torch.float32, device=dev)
        restart[sources_flat.to(dev).long()] = 1.0
        gov = torch.full((vpad,), num_graphs - 1, dtype=torch.int32,
                         device=dev)
        gov[:v] = gov_v
        deg = torch.zeros((vpad,), dtype=torch.int32, device=dev)
        deg[:v] = g.degrees.clamp(min=1).to(dev)
        dangling = torch.zeros((vpad,), dtype=torch.bool, device=dev)
        dangling[:v] = (g.degrees == 0).to(dev)
        real = torch.zeros((vpad,), dtype=torch.bool, device=dev)
        real[:v] = True
        return {"rank": restart, "restart": restart, "deg": deg,
                "dangling": dangling, "real": real, "gov": gov}, {}

    def round_fn(rt, e, st, sc, it):
        rank = st["rank"]
        gov = st["gov"].long()
        contrib = d * rank[e.my_src] / st["deg"][e.my_src].to(torch.float32)
        acc, _ = rt.wave(torch.zeros_like(rank), e.dst, contrib, e.valid,
                         op="add")
        dm = rt.psum(segment_sum(torch.where(st["dangling"], rank, 0.0),
                                 gov, num_graphs))                  # [G]
        rank = torch.where(st["real"],
                           st["restart"] * ((1.0 - d) + d * dm[gov]) + acc,
                           0.0)
        return dict(st, rank=rank), sc, True

    alg = AlgorithmSpec("graphs_ppr", "FF&AS", init, round_fn,
                        lambda g, layout: iters)
    res = run_distributed(alg, mesh, gs, capacity=capacity, axis=axis,
                          spec=spec, max_subrounds=max_subrounds)
    return res.state["rank"][:v]


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


def distributed_multi_source_pagerank(mesh, g: Graph, sources, *,
                                      iters: int = 20,
                                      capacity: int | str = 4096,
                                      m: int | None = None,
                                      axis: str = "data", d: float = 0.85,
                                      spec: C.CommitSpec | None = None,
                                      max_subrounds: int = 64,
                                      telemetry: bool = False):
    """Lane-batched personalized PageRank on the wave engine: FF&AS
    accumulate waves on vertex-major [vpad * L] state, per-lane dangling
    mass psum'd as an [L] vector.  Returns rank [L, V];
    ``telemetry=True`` returns (rank, DistributedResult)."""
    dev = mesh.device
    v = g.num_vertices
    sources = torch.as_tensor(sources, device=dev).long()
    lanes = sources.shape[0]
    lidx = torch.arange(lanes, device=dev)

    def init(g, layout):
        vpad = layout.vpad
        restart = torch.zeros((vpad * lanes,), dtype=torch.float32,
                              device=dev)
        restart[sources * lanes + lidx] = 1.0
        deg = torch.zeros((vpad,), dtype=torch.int32, device=dev)
        deg[:v] = g.degrees.clamp(min=1).to(dev)
        dangling = torch.zeros((vpad,), dtype=torch.bool, device=dev)
        dangling[:v] = (g.degrees == 0).to(dev)
        return {"rank": restart, "restart": restart, "deg": deg,
                "dangling": dangling}, {}

    def round_fn(rt, e, st, sc, it):
        rank = st["rank"]                      # [block * L]
        emax = e.dst.shape[0]
        fl = e.my_src[:, None] * lanes + lidx[None, :]
        contrib = d * rank[fl] / st["deg"][e.my_src].to(
            torch.float32)[:, None]
        tgt = e.dst[:, None].expand(emax, lanes)
        lane = lidx.to(torch.int32)[None, :].expand(emax, lanes)
        valid = e.valid[:, None].expand(emax, lanes)
        acc, _ = rt.wave(torch.zeros_like(rank), tgt.reshape(-1),
                         contrib.reshape(-1), valid.reshape(-1), op="add",
                         major=lane.reshape(-1))
        rk = rank.reshape(-1, lanes)
        dm = rt.psum(torch.where(st["dangling"][:, None], rk, 0.0)
                     .sum(0))                                       # [L]
        rank2 = st["restart"].reshape(-1, lanes) \
            * ((1.0 - d) + d * dm[None, :]) + acc.reshape(-1, lanes)
        return dict(st, rank=rank2.reshape(-1)), sc, True

    alg = AlgorithmSpec("multi_ppr", "FF&AS", init, round_fn,
                        lambda g, layout: iters)
    res = run_distributed(alg, mesh, g, capacity=capacity, m=m, axis=axis,
                          spec=spec, max_subrounds=max_subrounds,
                          batch=QueryLanes(lanes, v))
    rank = res.state["rank"].reshape(-1, lanes).T[:, :v]
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
