"""BFS — FF&MF atomic active messages (paper §3.3.2, Listing 4).

Label-correcting edge-centric formulation: every round, each edge whose
source is in the frontier emits a message ``(dst, dist[src]+1)``; messages
commit with the MF ``min`` operator (losers fail silently); the next
frontier is the set of vertices whose distance changed.  The round loop
runs on the host and reads one flag per round.  :func:`multi_source_bfs`
runs L queries as lanes of one wave, :func:`batched_over_graphs_bfs` one
query per tenant graph of a :class:`~repro_torch.graphs.csr.GraphSet`;
the ``distributed_*`` forms run on the wave engine
(:mod:`repro_torch.core.engine`), :func:`distributed_product_bfs` L
queries over each graph of a set.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.core import autotune as AT
from repro_torch.core import commit as C
from repro_torch.core.coalescing import ProductAxis, QueryLanes
from repro_torch.core.engine import (AlgorithmSpec, run_distributed,
                                     telemetry_return)
from repro_torch.core.messages import lane_messages, make_messages
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
    step, lvl = AT.make_commit_step(spec, "min", dist, n=g.num_edges)
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


def multi_source_bfs(g: Graph, sources, *, commit: str = "coarse",
                     m: int | None = None, sort: bool = True,
                     spec: C.CommitSpec | None = None) -> BfsResult:
    """L independent BFS queries as lanes of one fused wave.

    ``sources`` is [L]; the result's ``dist`` is [L, V], row l equal to
    ``bfs(g, sources[l]).dist`` (lanes occupy disjoint composite key
    ranges ``lane * V + v``).  Converged lanes stop emitting messages."""
    if spec is None:
        spec = C.CommitSpec(backend=commit, m=m, sort=sort, stats=False)
    v = g.num_vertices
    sources = torch.as_tensor(sources, device=g.device).long()
    lanes = sources.shape[0]
    lidx = torch.arange(lanes, device=g.device)
    dist = torch.full((lanes, v), INF, dtype=torch.int32, device=g.device)
    dist[lidx, sources] = 0
    frontier = torch.zeros((lanes, v), dtype=torch.bool, device=g.device)
    frontier[lidx, sources] = True
    dst_l = g.dst.expand(lanes, g.num_edges)
    step, lvl = AT.make_commit_step(spec, "min", dist.reshape(-1),
                                    n=lanes * g.num_edges, axis_width=lanes)
    zero = torch.zeros((), dtype=torch.int64, device=g.device)
    nmsg, ncf, nap = zero, zero, zero
    rounds = 0
    while rounds < v and bool(frontier.any()):
        active = frontier[:, g.src]            # per-lane early-exit mask
        msgs = lane_messages(dst_l, dist[:, g.src] + 1, active, v)
        res, lvl = step(dist.reshape(-1), msgs, lvl)
        dist2 = res.state.reshape(lanes, v)
        frontier = dist2 != dist
        dist = dist2
        rounds += 1
        nmsg = nmsg + active.sum()
        ncf = ncf + res.conflicts
        nap = nap + res.applied
    return BfsResult(dist, rounds, nmsg, ncf, nap)


def distributed_bfs(mesh, g: Graph, source, *, capacity: int | str = 4096,
                    m: int | None = None, axis: str = "data",
                    spec: C.CommitSpec | None = None, max_subrounds: int = 64,
                    telemetry: bool = False,
                    snapshot_rounds: int | None = None,
                    fault_injector=None):
    """BFS over a mesh axis: FF&MF ``min`` waves on the wave engine.

    Returns (dist [V], rounds); ``telemetry=True`` appends the
    :class:`~repro_torch.core.engine.DistributedResult`.
    ``snapshot_rounds``/``fault_injector`` enable degraded-mesh mode (see
    :func:`repro_torch.core.engine.run_distributed`)."""
    dev = mesh.device

    def init(g, layout):
        src = torch.as_tensor(source, device=dev).long()
        dist0 = torch.full((layout.vpad,), INF, dtype=torch.int32,
                           device=dev)
        dist0[src] = 0
        frontier0 = torch.zeros((layout.vpad,), dtype=torch.bool,
                                device=dev)
        frontier0[src] = True
        return {"dist": dist0, "frontier": frontier0}, {}

    def round_fn(rt, e, st, sc, it):
        dist = st["dist"]
        active = st["frontier"][e.my_src] & e.valid
        dist2, _ = rt.wave(dist, e.dst, dist[e.my_src] + 1, active,
                           op="min")
        changed = dist2 != dist
        return {"dist": dist2, "frontier": changed}, sc, rt.any(changed)

    alg = AlgorithmSpec("bfs", "FF&MF", init, round_fn,
                        lambda g, layout: layout.vpad)
    res = run_distributed(alg, mesh, g, capacity=capacity, m=m, axis=axis,
                          spec=spec, max_subrounds=max_subrounds,
                          snapshot_rounds=snapshot_rounds,
                          fault_injector=fault_injector)
    dist = res.state["dist"][:g.num_vertices]
    return telemetry_return((dist, res.rounds), res, telemetry)


def distributed_multi_source_bfs(mesh, g: Graph, sources, *,
                                 capacity: int | str = 4096,
                                 m: int | None = None, axis: str = "data",
                                 spec: C.CommitSpec | None = None,
                                 max_subrounds: int = 64,
                                 telemetry: bool = False,
                                 snapshot_rounds: int | None = None,
                                 fault_injector=None):
    """Lane-batched BFS over a mesh axis: L queries share every wave.

    Vertex state is vertex-major [vpad * L] (all lanes of a vertex live on
    its owner), lane ids ride the coalescing buckets as one more field,
    and owners commit on composite local keys.  Returns (dist [L, V],
    rounds); ``telemetry=True`` appends the DistributedResult.
    ``snapshot_rounds``/``fault_injector`` enable degraded-mesh mode (the
    [vpad * L] state is not vpad-shaped, so a shrink restarts the query
    from round 0 on the surviving mesh)."""
    dev = mesh.device
    sources = torch.as_tensor(sources, device=dev).long()
    lanes = sources.shape[0]
    lidx = torch.arange(lanes, device=dev)

    def init(g, layout):
        flat = sources * lanes + lidx           # vertex-major composite
        dist0 = torch.full((layout.vpad * lanes,), INF, dtype=torch.int32,
                           device=dev)
        dist0[flat] = 0
        frontier0 = torch.zeros((layout.vpad * lanes,), dtype=torch.bool,
                                device=dev)
        frontier0[flat] = True
        return {"dist": dist0, "frontier": frontier0}, {}

    def round_fn(rt, e, st, sc, it):
        dist = st["dist"]                       # [block * L]
        emax = e.dst.shape[0]
        fl = e.my_src[:, None] * lanes + lidx[None, :]      # [emax, L]
        active = st["frontier"][fl] & e.valid[:, None]
        tgt = e.dst[:, None].expand(emax, lanes)
        lane = lidx.to(torch.int32)[None, :].expand(emax, lanes)
        dist2, _ = rt.wave(dist, tgt.reshape(-1),
                           (dist[fl] + 1).reshape(-1), active.reshape(-1),
                           op="min", major=lane.reshape(-1))
        changed = dist2 != dist
        return {"dist": dist2, "frontier": changed}, sc, rt.any(changed)

    alg = AlgorithmSpec("multi_bfs", "FF&MF", init, round_fn,
                        lambda g, layout: layout.vpad)
    res = run_distributed(alg, mesh, g, capacity=capacity, m=m, axis=axis,
                          spec=spec, max_subrounds=max_subrounds,
                          batch=QueryLanes(lanes, g.num_vertices),
                          snapshot_rounds=snapshot_rounds,
                          fault_injector=fault_injector)
    dist = res.state["dist"].reshape(-1, lanes).T[:, :g.num_vertices]
    return telemetry_return((dist, res.rounds), res, telemetry)


def distributed_product_bfs(mesh, gs, sources, *,
                            capacity: int | str = 4096,
                            m: int | None = None, axis: str = "data",
                            spec: C.CommitSpec | None = None,
                            max_subrounds: int = 64,
                            telemetry: bool = False):
    """Product-axis BFS over a mesh axis: L queries over each graph of a
    :class:`~repro_torch.graphs.csr.GraphSet` share every wave.

    ``sources`` is int [L, G], graph-local source ids (cell (l, g)
    answers BFS from ``sources[l, g]`` in graph g).  State is
    vertex-major [vpad * L] over the union; the lane id rides the
    exchange as ``major`` as in :func:`distributed_multi_source_bfs`, and
    only ``batch=ProductAxis(L, sizes)`` differs.  Returns (dist [L, Vtot],
    rounds), ``telemetry=True`` appending the DistributedResult; split
    per graph with ``gs.split_vertex(dist[l])``."""
    dev = mesh.device
    sources = torch.as_tensor(sources, device=dev).long()
    lanes = sources.shape[0]
    lidx = torch.arange(lanes, device=dev)
    product = ProductAxis(lanes, gs.axis.sizes)
    # per-cell union-flat source ids [L, G]
    flat_src = sources + torch.as_tensor(gs.voffs[:-1], device=dev)[None, :]

    def init(g, layout):
        flat = (flat_src * lanes + lidx[:, None]).reshape(-1)
        dist0 = torch.full((layout.vpad * lanes,), INF, dtype=torch.int32,
                           device=dev)
        dist0[flat] = 0
        return {"dist": dist0, "frontier": dist0 == 0}, {}

    def round_fn(rt, e, st, sc, it):
        dist = st["dist"]                       # [block * L]
        emax = e.dst.shape[0]
        fl = e.my_src[:, None] * lanes + lidx[None, :]      # [emax, L]
        active = st["frontier"][fl] & e.valid[:, None]
        tgt = e.dst[:, None].expand(emax, lanes)
        lane = lidx.to(torch.int32)[None, :].expand(emax, lanes)
        dist2, _ = rt.wave(dist, tgt.reshape(-1),
                           (dist[fl] + 1).reshape(-1), active.reshape(-1),
                           op="min", major=lane.reshape(-1))
        changed = dist2 != dist
        return {"dist": dist2, "frontier": changed}, sc, rt.any(changed)

    alg = AlgorithmSpec("product_bfs", "FF&MF", init, round_fn,
                        lambda g, layout: layout.vpad)
    res = run_distributed(alg, mesh, gs, capacity=capacity, m=m,
                          axis=axis, spec=spec,
                          max_subrounds=max_subrounds, batch=product)
    dist = res.state["dist"].reshape(-1, lanes).T[:, :product.num_vertices]
    return telemetry_return((dist, res.rounds), res, telemetry)


def batched_over_graphs_bfs(gs, sources, *, spec: C.CommitSpec | None = None,
                            mesh=None, capacity: int | str = 4096,
                            axis: str = "data", max_subrounds: int = 64):
    """G independent BFS queries, one per tenant graph, as one wave over
    the :class:`~repro_torch.graphs.csr.GraphSet` union (flat keys
    ``offset[g] + v``).

    ``sources[g]`` is graph g's local source id.  Returns a list of
    per-graph distance rows, each bit-identical to
    ``bfs(gs.graphs[g], sources[g])`` on every backend: graphs exchange
    no messages in the union and occupy disjoint commit-key ranges.
    ``mesh=`` runs on the wave engine."""
    flat = gs.flat_vertices(sources)
    if mesh is not None:
        dist, _ = distributed_bfs(mesh, gs, flat, spec=spec,
                                  capacity=capacity, axis=axis,
                                  max_subrounds=max_subrounds)
    else:
        dist = bfs(gs.union(), flat, spec=spec).dist
    return gs.split_vertex(dist)


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
