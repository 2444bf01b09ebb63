"""SSSP (Bellman-Ford label-correcting) — FF&MF messages, weighted ``min``
commit.  Same AAM structure as BFS with ``dist[src] + w`` payloads;
:func:`multi_source_sssp` runs L roots as lanes of one wave,
:func:`batched_over_graphs_sssp` one root per tenant graph of a
:class:`~repro_torch.graphs.csr.GraphSet`, and the ``distributed_*`` forms
run on the wave engine."""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.core import autotune as AT
from repro_torch.core import commit as C
from repro_torch.core.coalescing import QueryLanes
from repro_torch.core.engine import (AlgorithmSpec, run_distributed,
                                     telemetry_return)
from repro_torch.core.messages import lane_messages, make_messages
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
    step, lvl = AT.make_commit_step(spec, "min", dist, n=g.num_edges)
    rounds = 0
    while rounds < v and bool(frontier.any()):
        active = frontier[g.src]
        msgs = make_messages(g.dst, dist[g.src] + g.weights, active)
        res, lvl = step(dist, msgs, lvl)
        frontier = res.state != dist
        dist = res.state
        rounds += 1
    return dist, rounds


def multi_source_sssp(g: Graph, sources, *, commit: str = "coarse",
                      m: int | None = None, sort: bool = True,
                      spec: C.CommitSpec | None = None):
    """L independent SSSP roots as lanes of one fused wave.  Returns
    (dist [L, V], rounds); row l equals ``sssp(g, sources[l])[0]``."""
    if spec is None:
        spec = C.CommitSpec(backend=commit, m=m, sort=sort, stats=False)
    v = g.num_vertices
    sources = torch.as_tensor(sources, device=g.device).long()
    lanes = sources.shape[0]
    lidx = torch.arange(lanes, device=g.device)
    dist = torch.full((lanes, v), INF, dtype=torch.float32, device=g.device)
    dist[lidx, sources] = 0.0
    frontier = torch.zeros((lanes, v), dtype=torch.bool, device=g.device)
    frontier[lidx, sources] = True
    dst_l = g.dst.expand(lanes, g.num_edges)
    step, lvl = AT.make_commit_step(spec, "min", dist.reshape(-1),
                                    n=lanes * g.num_edges, axis_width=lanes)
    rounds = 0
    while rounds < v and bool(frontier.any()):
        active = frontier[:, g.src]
        msgs = lane_messages(dst_l, dist[:, g.src] + g.weights[None, :],
                             active, v)
        res, lvl = step(dist.reshape(-1), msgs, lvl)
        dist2 = res.state.reshape(lanes, v)
        frontier = dist2 != dist
        dist = dist2
        rounds += 1
    return dist, rounds


def distributed_sssp(mesh, g: Graph, source, *, capacity: int | str = 4096,
                     m: int | None = None, axis: str = "data",
                     spec: C.CommitSpec | None = None,
                     max_subrounds: int = 64, telemetry: bool = False):
    """Bellman-Ford SSSP on the wave engine: FF&MF waves whose f32
    relaxation payloads ride next to the int32 targets in the same
    buckets.  Returns (dist [V], rounds); ``telemetry=True`` appends the
    DistributedResult."""
    dev = mesh.device

    def init(g, layout):
        src = torch.as_tensor(source, device=dev).long()
        dist0 = torch.full((layout.vpad,), INF, dtype=torch.float32,
                           device=dev)
        dist0[src] = 0.0
        frontier0 = torch.zeros((layout.vpad,), dtype=torch.bool,
                                device=dev)
        frontier0[src] = True
        return {"dist": dist0, "frontier": frontier0}, {}

    def round_fn(rt, e, st, sc, it):
        dist = st["dist"]
        active = st["frontier"][e.my_src] & e.valid
        dist2, _ = rt.wave(dist, e.dst, dist[e.my_src] + e.weight, active,
                           op="min")
        changed = dist2 != dist
        return {"dist": dist2, "frontier": changed}, sc, rt.any(changed)

    alg = AlgorithmSpec("sssp", "FF&MF", init, round_fn,
                        lambda g, layout: layout.vpad)
    res = run_distributed(alg, mesh, g, capacity=capacity, m=m, axis=axis,
                          spec=spec, max_subrounds=max_subrounds)
    dist = res.state["dist"][:g.num_vertices]
    return telemetry_return((dist, res.rounds), res, telemetry)


def distributed_multi_source_sssp(mesh, g: Graph, sources, *,
                                  capacity: int | str = 4096,
                                  m: int | None = None, axis: str = "data",
                                  spec: C.CommitSpec | None = None,
                                  max_subrounds: int = 64,
                                  telemetry: bool = False):
    """Lane-batched Bellman-Ford on the wave engine (vertex-major
    [vpad * L] state, lane ids riding the coalescing buckets), the
    distributed mirror of :func:`multi_source_sssp`.  Returns
    (dist [L, V], rounds); ``telemetry=True`` appends the
    DistributedResult."""
    dev = mesh.device
    sources = torch.as_tensor(sources, device=dev).long()
    lanes = sources.shape[0]
    lidx = torch.arange(lanes, device=dev)

    def init(g, layout):
        dist0 = torch.full((layout.vpad * lanes,), INF, dtype=torch.float32,
                           device=dev)
        dist0[sources * lanes + lidx] = 0.0
        return {"dist": dist0, "frontier": dist0 == 0}, {}

    def round_fn(rt, e, st, sc, it):
        dist = st["dist"]
        emax = e.dst.shape[0]
        fl = e.my_src[:, None] * lanes + lidx[None, :]
        active = st["frontier"][fl] & e.valid[:, None]
        tgt = e.dst[:, None].expand(emax, lanes)
        lane = lidx.to(torch.int32)[None, :].expand(emax, lanes)
        dist2, _ = rt.wave(dist, tgt.reshape(-1),
                           (dist[fl] + e.weight[:, None]).reshape(-1),
                           active.reshape(-1), op="min",
                           major=lane.reshape(-1))
        changed = dist2 != dist
        return {"dist": dist2, "frontier": changed}, sc, rt.any(changed)

    alg = AlgorithmSpec("multi_sssp", "FF&MF", init, round_fn,
                        lambda g, layout: layout.vpad)
    res = run_distributed(alg, mesh, g, capacity=capacity, m=m, axis=axis,
                          spec=spec, max_subrounds=max_subrounds,
                          batch=QueryLanes(lanes, g.num_vertices))
    dist = res.state["dist"].reshape(-1, lanes).T[:, :g.num_vertices]
    return telemetry_return((dist, res.rounds), res, telemetry)


def batched_over_graphs_sssp(gs, sources, *,
                             spec: C.CommitSpec | None = None,
                             mesh=None, capacity: int | str = 4096,
                             axis: str = "data", max_subrounds: int = 64):
    """G independent SSSP queries, one per tenant graph, fused on the
    graph batch axis.  ``sources[g]`` is graph g's local root.  Returns
    per-graph f32 distance rows, bit-identical to
    ``sssp(gs.graphs[g], sources[g])`` on every backend (f32 ``min`` over
    the same relaxations is order-independent)."""
    flat = gs.flat_vertices(sources)
    if mesh is not None:
        dist, _ = distributed_sssp(mesh, gs, flat, spec=spec,
                                   capacity=capacity, axis=axis,
                                   max_subrounds=max_subrounds)
    else:
        dist, _ = sssp(gs.union(), flat, spec=spec)
    return gs.split_vertex(dist)


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
