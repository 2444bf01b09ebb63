"""Boman graph coloring — FR&MF messages (paper §3.3.5, Listing 7).

Rounds: every active vertex proposes a color; conflicts (edge endpoints
with equal color) are resolved by a seeded coin flip choosing which
endpoint recolors (the paper's "return the ID of a vertex to be
recolored" failure handler, expressed as the FR path).  Ends when no edge
conflicts remain.

The proposals and coins are the reference's uint32 hashes, computed here
in int64 holding values in [0, 2^32): every product is split so that it
stays below 2^49, and every result is masked back to 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import autotune as AT
from repro_torch.core import commit as C
from repro_torch.core.engine import (AlgorithmSpec, run_distributed,
                                     telemetry_return)
from repro_torch.core.messages import make_messages
from repro_torch.graphs.csr import Graph, segment_sum

_M32 = 0xFFFFFFFF


def _u32(x):
    """``x`` as a uint32 value held in int64 (Python ints stay ints)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _mul32(x, c: int):
    """``x * c`` modulo 2^32 for ``x`` in [0, 2^32), the constant split in
    16-bit halves so that no product passes 2^48."""
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    x = _mul32(x ^ (x >> 16), 0x7feb352d)
    x = _mul32(x ^ (x >> 15), 0x846ca68b)
    return x ^ (x >> 16)


def _pair_loser(src, dst, seed, rnd):
    """Seeded coin flip per conflicting edge: which endpoint recolors.
    Hashed on the canonical (lo, hi) pair so both stored directions of an
    undirected edge, and every shard of a distributed run, agree on the
    loser.  Returns int32."""
    lo = _u32(torch.minimum(src, dst))
    hi = _u32(torch.maximum(src, dst))
    mix = _u32(seed * 31 + 7) ^ _hash32(_u32(rnd))
    coin = (_hash32(lo ^ _hash32(hi ^ mix)) & 1) == 0
    return torch.where(coin, lo, hi).to(torch.int32)


def _propose(ids, active, color, pal, seed, rnd):
    """Seeded per-round color proposal for the ``active`` vertices: a pure
    function of the vertex id, so every shard proposes exactly what the
    single-shard run would.  ``pal`` is an int or a per-vertex tensor."""
    mix = (_u32(seed) + _mul32(_u32(rnd), 2654435761)) & _M32
    h = _hash32(_u32(ids) ^ _hash32(mix))
    prop = (h % _u32(pal)).to(torch.int32)
    return torch.where(active, prop, color)


def coloring(g: Graph, *, palette: int | None = None, seed: int = 0,
             max_rounds: int = 500, spec: C.CommitSpec | None = None):
    """Returns (color [V] int32, rounds, not_converged 0-d bool).  The
    palette is Δ + 1 colors; ``palette`` is accepted and unused, as in
    the reference."""
    if spec is None:
        # sort=False: the 0/1 recolor mask needs no in-batch resolution
        spec = C.CommitSpec(backend="coarse", sort=False, stats=False)
    v, dev = g.num_vertices, g.device
    pal = int(g.degrees.max()) + 1
    ids = torch.arange(v, device=dev)
    zeros = torch.zeros((v,), dtype=torch.int32, device=dev)
    ones = torch.ones((g.num_edges,), dtype=torch.int32, device=dev)
    step, lvl = AT.make_commit_step(spec, "or", zeros, n=g.num_edges)
    color = zeros
    active = torch.ones((v,), dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < max_rounds and bool(active.any()):
        color = _propose(ids, active, color, pal, seed, rounds)
        conflict = color[g.src] == color[g.dst]
        loser = _pair_loser(g.src, g.dst, seed, rounds)
        # the recolor notification is an "or" commit into the next
        # round's active mask (losers may be named by many edges)
        res, lvl = step(zeros, make_messages(loser, ones, conflict), lvl)
        active = res.state != 0
        rounds += 1
    return color, rounds, active.any()


def _union_coloring(g: Graph, gov, lid, voffs_e, lsrc, ldst, pal, seed, *,
                    max_rounds: int, spec: C.CommitSpec | None,
                    num_graphs: int, axis_width: int):
    """Boman coloring over a disjoint-union graph, bit-identical per
    member: proposals hash local vertex ids against the member's own
    palette and the coin flips hash local canonical pairs, exactly what
    each single-graph run computes, while the recolor notifications of
    all graphs share one ``or`` commit on flat keys."""
    v, dev = g.num_vertices, g.device
    zeros = torch.zeros((v,), dtype=torch.int32, device=dev)
    ones = torch.ones((g.num_edges,), dtype=torch.int32, device=dev)
    step, lvl = AT.make_commit_step(spec, "or", zeros, n=g.num_edges,
                                    axis_width=axis_width)
    pal_v = pal[gov.long()]
    color = zeros
    active = torch.ones((v,), dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < max_rounds and bool(active.any()):
        color = _propose(lid, active, color, pal_v, seed, rounds)
        conflict = color[g.src] == color[g.dst]
        loser = _pair_loser(lsrc, ldst, seed, rounds) + voffs_e
        res, lvl = step(zeros, make_messages(loser, ones, conflict), lvl)
        active = res.state != 0
        rounds += 1
    not_conv = segment_sum(active.to(torch.int32), gov, num_graphs) > 0
    return color, rounds, not_conv


def _graphset_locals(gs):
    """Local-id views of a GraphSet: (gov [V] int32, lid [V] int64, each
    edge's graph vertex offset [E] int32, local src/dst [E] int32, pal [G]
    int64 = each member's max degree + 1)."""
    dev = gs.device
    voffs = torch.as_tensor(gs.voffs[:-1], dtype=torch.int32, device=dev)
    gov = gs.graph_of_vertex()
    lid = (torch.arange(gs.num_vertices, dtype=torch.int32, device=dev)
           - voffs[gov.long()]).to(torch.int64)
    voffs_e = voffs[gs.graph_of_edge().long()]
    u = gs.union()
    pal = torch.tensor([int(g.degrees.max()) + 1 for g in gs.graphs],
                       dtype=torch.int64, device=dev)
    return gov, lid, voffs_e, u.src - voffs_e, u.dst - voffs_e, pal


def batched_over_graphs_coloring(gs, *, seed: int = 0,
                                 max_rounds: int = 500,
                                 spec: C.CommitSpec | None = None,
                                 mesh=None, capacity: int | str = 4096,
                                 axis: str = "data",
                                 max_subrounds: int = 64):
    """G independent colorings, one per tenant graph, as one fused wave
    sequence on disjoint flat key ranges.

    Returns ``(colors, rounds, not_converged)``: per-graph color rows
    (each bit-identical to ``coloring(gs.graphs[g], seed=seed)`` on every
    backend), the fused round count (the max over members), and a [G]
    bool tensor.  ``mesh=`` runs on the wave engine."""
    if spec is None:
        spec = C.CommitSpec(backend="coarse", sort=False, stats=False)
    gov, lid, voffs_e, lsrc, ldst, pal = _graphset_locals(gs)
    if mesh is not None:
        color, rounds, not_conv = _distributed_union_coloring(
            mesh, gs, pal, seed=seed, max_rounds=max_rounds, spec=spec,
            capacity=capacity, axis=axis, max_subrounds=max_subrounds)
    else:
        color, rounds, not_conv = _union_coloring(
            gs.union(), gov, lid, voffs_e, lsrc, ldst, pal, seed,
            max_rounds=max_rounds, spec=spec, num_graphs=gs.num_graphs,
            axis_width=gs.num_graphs)
    return gs.split_vertex(color), rounds, not_conv


def _distributed_union_coloring(mesh, gs, pal, *, seed, max_rounds, spec,
                                capacity, axis, max_subrounds):
    """Graph-batched coloring on the wave engine: the same local-id
    proposals and coins as :func:`_union_coloring`, with remote endpoint
    colors read through the FR gather path."""
    dev = mesh.device
    v = gs.num_vertices
    num_graphs = gs.num_graphs
    gov_v = gs.graph_of_vertex().to(dev)
    voffs = torch.as_tensor(gs.voffs, dtype=torch.int32, device=dev)
    pal = pal.to(dev)

    def init(g, layout):
        vpad = layout.vpad
        gov = torch.full((vpad,), num_graphs - 1, dtype=torch.int32,
                         device=dev)
        gov[:v] = gov_v
        active = torch.zeros((vpad,), dtype=torch.bool, device=dev)
        active[:v] = True
        return {"color": torch.zeros((vpad,), dtype=torch.int32, device=dev),
                "active": active, "gov": gov}, {}

    def round_fn(rt, e, st, sc, it):
        gov = st["gov"].long()
        color = _propose(rt.gid - voffs[gov], st["active"], st["color"],
                         pal[gov], seed, it)
        cs = color[e.my_src]
        cd = rt.gather(color, e.dst, e.valid, fill=-1)
        conflict = e.valid & (cs == cd)
        eoff = voffs[torch.searchsorted(voffs[1:], e.src, right=True)
                     .clamp(0, num_graphs - 1)]
        loser = _pair_loser(e.src - eoff, e.dst - eoff, seed, it) + eoff
        act, _ = rt.wave(torch.zeros_like(color), loser,
                         torch.ones_like(e.src), conflict, op="or")
        new_active = act != 0
        return (dict(st, color=color, active=new_active), sc,
                rt.any(new_active))

    alg = AlgorithmSpec("graphs_coloring", "FR&MF", init, round_fn,
                        lambda g, layout: max_rounds)
    res = run_distributed(alg, mesh, gs, capacity=capacity, axis=axis,
                          spec=spec, max_subrounds=max_subrounds)
    not_conv = segment_sum(res.state["active"][:v].to(torch.int32), gov_v,
                           num_graphs) > 0
    return res.state["color"][:v], res.rounds, not_conv


def distributed_coloring(mesh, g: Graph, *, seed: int = 0,
                         max_rounds: int = 500, capacity: int = 4096,
                         m: int | None = None, axis: str = "data",
                         spec: C.CommitSpec | None = None,
                         max_subrounds: int = 64, telemetry: bool = False):
    """Boman coloring on the wave engine, FR&MF rounds: propose locally,
    gather remote endpoint colors, and commit the pair-hash loser's
    recolor notification as an ``or`` wave.  Proposals and coins are
    pure functions of global ids, so the run matches the single-shard
    :func:`coloring` bit for bit.

    Returns (color [V], rounds, not_converged); ``telemetry=True``
    appends the DistributedResult."""
    dev = mesh.device
    pal = int(g.degrees.max()) + 1

    def init(g, layout):
        return {"color": torch.zeros((layout.vpad,), dtype=torch.int32,
                                     device=dev),
                "active": torch.ones((layout.vpad,), dtype=torch.bool,
                                     device=dev)}, {}

    def round_fn(rt, e, st, sc, it):
        color = _propose(rt.gid, st["active"], st["color"], pal, seed, it)
        cs = color[e.my_src]
        cd = rt.gather(color, e.dst, e.valid, fill=-1)
        conflict = e.valid & (cs == cd)
        loser = _pair_loser(e.src, e.dst, seed, it)
        act, _ = rt.wave(torch.zeros_like(color), loser,
                         torch.ones_like(e.src), conflict, op="or")
        new_active = act != 0
        return ({"color": color, "active": new_active}, sc,
                rt.any(new_active))

    alg = AlgorithmSpec("coloring", "FR&MF", init, round_fn,
                        lambda g, layout: max_rounds)
    res = run_distributed(alg, mesh, g, capacity=capacity, m=m, axis=axis,
                          spec=spec, max_subrounds=max_subrounds)
    color = res.state["color"][:g.num_vertices]
    not_converged = res.state["active"][:g.num_vertices].any()
    out = (color, res.rounds, not_converged)
    return telemetry_return(out, res, telemetry)


def validate_coloring(g: Graph, color) -> bool:
    """Oracle (tests): no edge joins two vertices of one color."""
    c = np.asarray(torch.as_tensor(color).cpu())
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    return bool((c[src] != c[dst]).all())
