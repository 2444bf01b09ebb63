"""ST-connectivity — FR&AS messages (paper §3.3.4, Listing 6).

Two concurrent BFS waves ("grey" from s, "green" from t) color white
vertices with a first-writer-wins commit; an edge whose endpoints carry
different non-white colors proves connectivity (the operator's ``return
true`` routed back to the spawner, which ends the run).  Round loops run
on the host and read one flag per round.  :func:`multi_source_stconn`
runs L queries as mark lanes of one ``or`` wave, the ``batched_over_*``
form one query per tenant graph of a
:class:`~repro_torch.graphs.csr.GraphSet`, and the ``distributed_*``
forms run on the wave engine (:mod:`repro_torch.core.engine`).
"""
from __future__ import annotations

import torch

from repro_torch.core import autotune as AT
from repro_torch.core import commit as C
from repro_torch.core.coalescing import QueryLanes
from repro_torch.core.engine import (AlgorithmSpec, run_distributed,
                                     telemetry_return)
from repro_torch.core.messages import lane_messages, make_messages
from repro_torch.graphs.algorithms.bfs import bfs_reference
from repro_torch.graphs.csr import Graph, segment_sum

WHITE, GREY, GREEN = -1, 1, 2


def st_connectivity(g: Graph, s: int, t: int, *,
                    spec: C.CommitSpec | None = None):
    """Whether ``t`` is reachable from ``s``.  Returns (found, rounds):
    a 0-d bool tensor on ``g``'s device and an int."""
    if spec is None:
        spec = C.CommitSpec(backend="coarse")
    v, dev = g.num_vertices, g.device
    s, t = int(s), int(t)
    color = torch.full((v,), WHITE, dtype=torch.int32, device=dev)
    color[s] = GREY
    color[t] = GREEN
    frontier = torch.zeros((v,), dtype=torch.bool, device=dev)
    frontier[s] = True
    frontier[t] = True
    step, lvl = AT.make_commit_step(spec, "first", color, n=g.num_edges)
    # s == t is connected by the empty path (the wave cannot say so: s's
    # GREY is overwritten by t's GREEN at init)
    found = torch.tensor(s == t, device=dev)
    rounds = 0
    while rounds < v and bool(frontier.any() & ~found):
        active = frontier[g.src]
        cs, cd = color[g.src], color[g.dst]
        # meeting check on live edges (the FR "returns true" path)
        meet = active & (cs != WHITE) & (cd != WHITE) & (cs != cd)
        found = found | meet.any()
        res, lvl = step(color, make_messages(g.dst, cs, active), lvl)
        frontier = res.state != color
        color = res.state
        rounds += 1
    return found, rounds


def multi_source_stconn(g: Graph, ss, ts, *,
                        spec: C.CommitSpec | None = None):
    """L s-t connectivity queries as one fused wave.

    Query l runs its two BFS waves as lanes 2l (grey, from ``ss[l]``) and
    2l+1 (green, from ``ts[l]``) of a [2L, V] ``or``-mark state;
    connectivity is proven where both marks meet.  Returns (found [L]
    bool, rounds); answered queries stop emitting messages while the wave
    serves the rest."""
    if spec is None:
        spec = C.CommitSpec(backend="coarse")
    v, e, dev = g.num_vertices, g.num_edges, g.device
    ss = torch.as_tensor(ss, device=dev).long()
    ts = torch.as_tensor(ts, device=dev).long()
    lanes = ss.shape[0]
    l2 = 2 * lanes
    lidx = torch.arange(lanes, device=dev)
    marks = torch.zeros((l2, v), dtype=torch.int32, device=dev)
    marks[2 * lidx, ss] = 1
    marks[2 * lidx + 1, ts] = 1
    frontier = marks != 0
    found = ss == ts
    dst_l = g.dst.expand(l2, e)
    step, lvl = AT.make_commit_step(spec, "or", marks.reshape(-1),
                                    n=l2 * e, axis_width=l2)
    rounds = 0

    def live_lanes():
        return torch.repeat_interleave(~found, 2)[:, None]

    while rounds < v and bool((frontier & live_lanes()).any()):
        active = frontier[:, g.src] & live_lanes()   # answered lanes go quiet
        msgs = lane_messages(dst_l, active.to(torch.int32), active, v)
        res, lvl = step(marks.reshape(-1), msgs, lvl)
        marks2 = res.state.reshape(l2, v)
        frontier = (marks2 != 0) & (marks == 0)
        meet = (marks2[0::2] != 0) & (marks2[1::2] != 0)      # [L, V]
        found = found | meet.any(1)
        marks = marks2
        rounds += 1
    return found, rounds


def _union_stconn(g: Graph, ss_flat, ts_flat, gov, egov, *,
                  spec: C.CommitSpec | None, num_graphs: int,
                  axis_width: int):
    """G s-t queries over a disjoint-union graph: grey marks live at flat
    keys [0, V), green at [V, 2V) (a nested 2-lane axis on top of the
    graph axis); per-graph found bits are segment reductions by the
    graph-of-vertex map ``gov``."""
    v, e, dev = g.num_vertices, g.num_edges, g.device
    ss_flat, ts_flat = ss_flat.long(), ts_flat.long()
    marks = torch.zeros((2 * v,), dtype=torch.int32, device=dev)
    marks[ss_flat] = 1
    marks[v + ts_flat] = 1
    frontier = marks != 0
    found = ss_flat == ts_flat
    tgt2 = torch.cat([g.dst, v + g.dst])
    step, lvl = AT.make_commit_step(spec, "or", marks, n=2 * e,
                                    axis_width=axis_width)
    rounds = 0

    def live():
        return frontier & (~found[gov]).repeat(2)

    while rounds < v and bool(live().any()):
        live_e = ~found[egov]                    # answered graphs go quiet
        active = torch.cat([frontier[g.src] & live_e,
                            frontier[v + g.src] & live_e])
        res, lvl = step(marks, make_messages(tgt2, active.to(torch.int32),
                                             active), lvl)
        frontier = (res.state != 0) & (marks == 0)
        meet = (res.state[:v] != 0) & (res.state[v:] != 0)      # [V]
        found = found | (segment_sum(meet.to(torch.int32), gov,
                                     num_graphs) > 0)
        marks = res.state
        rounds += 1
    return found, rounds


def batched_over_graphs_stconn(gs, ss, ts, *,
                               spec: C.CommitSpec | None = None,
                               mesh=None, capacity: int | str = 4096,
                               axis: str = "data",
                               max_subrounds: int = 64):
    """G s-t connectivity queries, one per tenant graph, fused on the
    graph batch axis.  ``ss[g]``/``ts[g]`` are graph g's local
    endpoints.  Returns found [G] bool; ``found[g]`` equals
    ``st_connectivity(gs.graphs[g], ss[g], ts[g])`` on every backend.
    ``mesh=`` runs on the wave engine."""
    if spec is None:
        spec = C.CommitSpec(backend="coarse")
    ss_flat = gs.flat_vertices(ss)
    ts_flat = gs.flat_vertices(ts)
    if mesh is not None:
        found, _ = _distributed_union_stconn(
            mesh, gs, ss_flat, ts_flat, spec=spec, capacity=capacity,
            axis=axis, max_subrounds=max_subrounds)
        return found
    found, _ = _union_stconn(gs.union(), ss_flat, ts_flat,
                             gs.graph_of_vertex(), gs.graph_of_edge(),
                             spec=spec, num_graphs=gs.num_graphs,
                             axis_width=2 * gs.num_graphs)
    return found


def _distributed_union_stconn(mesh, gs, ss_flat, ts_flat, *, spec,
                              capacity, axis, max_subrounds):
    """Graph-batched s-t connectivity on the wave engine: the union's
    grey/green marks ride as two payload fields through one coalescing
    bucket per round, per-graph found bits psum'd as a [G] vector."""
    dev = mesh.device
    v = gs.num_vertices
    num_graphs = gs.num_graphs
    gov_v = gs.graph_of_vertex().to(dev)
    voffs = torch.as_tensor(gs.voffs, dtype=torch.int32, device=dev)
    ss_flat, ts_flat = ss_flat.to(dev).long(), ts_flat.to(dev).long()

    def init(g, layout):
        vpad = layout.vpad

        def marks(at):
            out = torch.zeros((vpad,), dtype=torch.int32, device=dev)
            out[at] = 1
            return out
        gov = torch.full((vpad,), num_graphs - 1, dtype=torch.int32,
                         device=dev)
        gov[:v] = gov_v
        real = torch.zeros((vpad,), dtype=torch.bool, device=dev)
        real[:v] = True
        grey, green = marks(ss_flat), marks(ts_flat)
        state = {"grey": grey, "green": green, "fgrey": grey != 0,
                 "fgreen": green != 0, "gov": gov, "real": real}
        return state, {"found": ss_flat == ts_flat}

    def round_fn(rt, e, st, sc, it):
        egov = (torch.searchsorted(voffs[1:], e.src, right=True)
                .clamp(0, num_graphs - 1))
        live_e = e.valid & ~sc["found"][egov]
        ag = st["fgrey"][e.my_src] & live_e
        agr = st["fgreen"][e.my_src] & live_e
        marks, _ = rt.wave(
            {"grey": st["grey"], "green": st["green"]}, e.dst,
            {"grey": ag.to(torch.int32), "green": agr.to(torch.int32)},
            ag | agr, op="or")
        fgrey = (marks["grey"] != 0) & (st["grey"] == 0)
        fgreen = (marks["green"] != 0) & (st["green"] == 0)
        meet = (marks["grey"] != 0) & (marks["green"] != 0) & st["real"]
        found = sc["found"] | (rt.psum(segment_sum(
            meet.to(torch.int32), st["gov"], num_graphs)) > 0)
        live2 = (fgrey | fgreen) & ~found[st["gov"]] & st["real"]
        state = dict(st, grey=marks["grey"], green=marks["green"],
                     fgrey=fgrey, fgreen=fgreen)
        return state, {"found": found}, rt.any(live2)

    alg = AlgorithmSpec("graphs_stconn", "FR&AS", init, round_fn,
                        lambda g, layout: layout.vpad)
    res = run_distributed(alg, mesh, gs, capacity=capacity, axis=axis,
                          spec=spec, max_subrounds=max_subrounds)
    return res.scalars["found"], res.rounds


def distributed_stconn(mesh, g: Graph, s: int, t: int, *,
                       capacity: int | str = 4096, m: int | None = None,
                       axis: str = "data",
                       spec: C.CommitSpec | None = None,
                       max_subrounds: int = 64, telemetry: bool = False):
    """ST-connectivity on the wave engine: two concurrent BFS waves
    ("grey" from s, "green" from t) carried as two payload fields through
    one coalescing bucket per round (``or`` commits into two frontier
    marks); connectivity is proven when any vertex holds both marks (the
    FR "return true" routed back as a psum).

    Returns (found, rounds); ``telemetry=True`` appends the
    DistributedResult."""
    dev = mesh.device
    s, t = int(s), int(t)

    def init(g, layout):
        vpad = layout.vpad
        grey = torch.zeros((vpad,), dtype=torch.int32, device=dev)
        grey[s] = 1
        green = torch.zeros((vpad,), dtype=torch.int32, device=dev)
        green[t] = 1
        state = {"grey": grey, "green": green, "fgrey": grey != 0,
                 "fgreen": green != 0}
        return state, {"found": torch.tensor(s == t, device=dev)}

    def round_fn(rt, e, st, sc, it):
        ag = st["fgrey"][e.my_src] & e.valid
        agr = st["fgreen"][e.my_src] & e.valid
        marks, _ = rt.wave(
            {"grey": st["grey"], "green": st["green"]}, e.dst,
            {"grey": ag.to(torch.int32), "green": agr.to(torch.int32)},
            ag | agr, op="or")
        fgrey = (marks["grey"] != 0) & (st["grey"] == 0)
        fgreen = (marks["green"] != 0) & (st["green"] == 0)
        found = sc["found"] | rt.any((marks["grey"] != 0)
                                     & (marks["green"] != 0))
        state = {"grey": marks["grey"], "green": marks["green"],
                 "fgrey": fgrey, "fgreen": fgreen}
        active = (rt.any(fgrey) | rt.any(fgreen)) & ~found
        return state, {"found": found}, active

    alg = AlgorithmSpec("stconn", "FR&AS", init, round_fn,
                        lambda g, layout: layout.vpad)
    res = run_distributed(alg, mesh, g, capacity=capacity, m=m, axis=axis,
                          spec=spec, max_subrounds=max_subrounds)
    out = (res.scalars["found"], res.rounds)
    return telemetry_return(out, res, telemetry)


def distributed_multi_source_stconn(mesh, g: Graph, ss, ts, *,
                                    capacity: int | str = 4096,
                                    m: int | None = None,
                                    axis: str = "data",
                                    spec: C.CommitSpec | None = None,
                                    max_subrounds: int = 64,
                                    telemetry: bool = False):
    """Lane-batched s-t connectivity on the wave engine: 2L mark lanes on
    vertex-major [vpad * 2L] state, per-lane found bits psum'd each round
    (the FR "return true" as an [L] vector).  Returns (found [L],
    rounds); ``telemetry=True`` appends the DistributedResult."""
    dev = mesh.device
    ss = torch.as_tensor(ss, device=dev).long()
    ts = torch.as_tensor(ts, device=dev).long()
    lanes = ss.shape[0]
    l2 = 2 * lanes
    lidx = torch.arange(lanes, device=dev)
    l2idx = torch.arange(l2, device=dev)

    def init(g, layout):
        marks = torch.zeros((layout.vpad * l2,), dtype=torch.int32,
                            device=dev)
        marks[ss * l2 + 2 * lidx] = 1
        marks[ts * l2 + 2 * lidx + 1] = 1
        return {"marks": marks, "frontier": marks != 0}, {"found": ss == ts}

    def round_fn(rt, e, st, sc, it):
        emax = e.dst.shape[0]
        live = torch.repeat_interleave(~sc["found"], 2)        # [2L]
        fl = e.my_src[:, None] * l2 + l2idx[None, :]           # [emax, 2L]
        active = st["frontier"][fl] & e.valid[:, None] & live[None, :]
        tgt = e.dst[:, None].expand(emax, l2)
        lane = l2idx.to(torch.int32)[None, :].expand(emax, l2)
        marks2, _ = rt.wave(st["marks"], tgt.reshape(-1),
                            active.to(torch.int32).reshape(-1),
                            active.reshape(-1), op="or",
                            major=lane.reshape(-1))
        frontier2 = (marks2 != 0) & (st["marks"] == 0)
        mk = marks2.reshape(-1, l2)
        meet = (mk[:, 0::2] != 0) & (mk[:, 1::2] != 0)        # [block, L]
        found = sc["found"] | (rt.psum(meet.sum(0, dtype=torch.int32)) > 0)
        live2 = (frontier2.reshape(-1, l2)
                 & torch.repeat_interleave(~found, 2)[None, :])
        return {"marks": marks2, "frontier": frontier2}, \
            {"found": found}, rt.any(live2)

    alg = AlgorithmSpec("multi_stconn", "FR&AS", init, round_fn,
                        lambda g, layout: layout.vpad)
    res = run_distributed(alg, mesh, g, capacity=capacity, m=m, axis=axis,
                          spec=spec, max_subrounds=max_subrounds,
                          batch=QueryLanes(l2, g.num_vertices))
    out = (res.scalars["found"], res.rounds)
    return telemetry_return(out, res, telemetry)


def st_reference(g: Graph, s: int, t: int) -> bool:
    """Oracle (tests): whether ``bfs_reference`` from ``s`` reaches
    ``t``."""
    return bool(bfs_reference(g, s)[t] < 2 ** 29)
