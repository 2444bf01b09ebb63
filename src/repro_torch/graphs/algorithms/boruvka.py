"""Boruvka MST — FR&MF messages (paper §3.3.3, Listing 5).

Each round, every supervertex (component) selects its minimum-weight
outgoing edge (two ``min`` commits: the weight, then the edge id among
the edges of that weight; only the winning edge per component survives,
the paper's conflicting-activity semantics), components hook along the
selected edges, and pointer jumping contracts the forest.  Tie-breaking
is lexicographic (weight, edge id), so the MST is unique and testable
against :func:`mst_reference`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import autotune as AT
from repro_torch.core import commit as C
from repro_torch.core.engine import (AlgorithmSpec, run_distributed,
                                     telemetry_return)
from repro_torch.core.messages import make_messages
from repro_torch.graphs.csr import Graph, partition_tensors

INF = 3.0e38                # as float32: the "no outgoing edge" weight
HOOK_EMPTY = 2 ** 30


def _shortcut(parent, iters: int):
    """``iters`` pointer jumps ``p = p[p]``."""
    for _ in range(iters):
        parent = parent[parent.long()]
    return parent


def _dedupe_mst_pairs(g: Graph, in_mst):
    """Undirected graphs store both directions, so an MST edge may be
    selected from either side: count each canonical pair once (lexsorted
    dedupe).  ``in_mst``: bool [E] per-direction selection.  Returns
    (weight as a 0-d float32 tensor, n_edges as a 0-d int32 tensor)."""
    e, dev = g.num_edges, g.device
    lo = torch.minimum(g.src, g.dst)
    hi = torch.maximum(g.src, g.dst)
    o1 = torch.argsort(hi, stable=True)
    order = o1[torch.argsort(lo[o1], stable=True)]
    slo, shi, sm = lo[order], hi[order], in_mst[order]
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       (slo[1:] != slo[:-1]) | (shi[1:] != shi[:-1])])
    pair_id = torch.cumsum(first.to(torch.int32), 0) - 1
    pair_sel = torch.zeros((e,), dtype=torch.int32, device=dev) \
        .scatter_reduce_(0, pair_id.long(), sm.to(torch.int32), "amax")
    uniq = first & (pair_sel[pair_id.long()] > 0)
    weight = torch.where(uniq, g.weights[order], 0.0).sum()
    n_edges = uniq.sum(dtype=torch.int32)
    return weight, n_edges


def boruvka_forest(g: Graph, *, spec: C.CommitSpec | None = None,
                   axis_width: int = 1):
    """The Boruvka contraction loop: returns (comp [V] int32, in_mst [E]
    bool per-direction selection, rounds), the piece :func:`boruvka` and
    the graph-batched entry point share.  Every step is a shift-equivariant
    function of vertex and edge ids, so running it on a disjoint-union
    graph equals running it per member graph.  ``axis_width`` is the
    graph count of a batched caller."""
    if spec is None:
        # sort=False: a scatter-min; the sorted path would sort all E
        # edges twice per round
        spec = C.CommitSpec(backend="coarse", sort=False, stats=False)
    v, e, dev = g.num_vertices, g.num_edges, g.device
    jump = max(int(v).bit_length(), 1)
    inf_w = torch.full((v,), INF, dtype=torch.float32, device=dev)
    no_e = torch.full((v,), e, dtype=torch.int32, device=dev)
    # two commit sites with different state dtypes (f32 weights, i32 edge
    # ids)
    step_w, lvl_w = AT.make_commit_step(spec, "min", inf_w, n=e,
                                        axis_width=axis_width)
    step_e, lvl_e = AT.make_commit_step(spec, "min", no_e, n=e,
                                        axis_width=axis_width)
    ids = torch.arange(v, dtype=torch.int32, device=dev)
    eid = torch.arange(e, dtype=torch.int32, device=dev)
    comp = ids
    in_mst = torch.zeros((e,), dtype=torch.bool, device=dev)
    rounds, changed = 0, True
    while changed and rounds < jump + 1:
        cs, cd = comp[g.src], comp[g.dst]
        cross = cs != cd
        w = torch.where(cross, g.weights, INF)
        # two-pass lexicographic argmin (weight, edge id): each pass is an
        # MF min commit of per-edge messages into per-component state
        res_w, lvl_w = step_w(inf_w, make_messages(cs, g.weights, cross),
                              lvl_w)
        best_w = res_w.state[cs.long()]
        cand = cross & (w == best_w) & (best_w < INF)
        res_e, lvl_e = step_e(no_e, make_messages(cs, eid, cand), lvl_e)
        best_e = res_e.state
        has = best_e < e
        sel = best_e.clamp(0, e - 1).long()
        # hook: the root of cs points at the component of the chosen dst
        parent = torch.where(has, comp[g.dst[sel].long()], ids)
        # break mutual pairs (a <-> b): the larger id becomes a root
        mutual = (parent[parent.long()] == ids) & (ids > parent)
        parent = _shortcut(torch.where(mutual, ids, parent), jump)
        new_comp = parent[comp.long()]
        in_mst[sel[has]] = True
        changed = bool((new_comp != comp).any())
        comp = new_comp
        rounds += 1
    return comp, in_mst, rounds


def boruvka(g: Graph, *, spec: C.CommitSpec | None = None):
    """Returns (comp [V], MST weight, MST edge count, rounds)."""
    comp, in_mst, rounds = boruvka_forest(g, spec=spec)
    weight, n_edges = _dedupe_mst_pairs(g, in_mst)
    return comp, weight, n_edges, rounds


def batched_over_graphs_boruvka(gs, *, spec: C.CommitSpec | None = None,
                                mesh=None, capacity: int | str = 4096,
                                axis: str = "data",
                                max_subrounds: int = 64):
    """G independent MSTs, one per tenant graph, as one fused Boruvka run
    over the :class:`~repro_torch.graphs.csr.GraphSet` union (disjoint
    component-id key ranges in the two min commits, disjoint edge-id
    ranges in the selection).

    Returns ``([(comp, weight, n_edges)] per graph, rounds)``; each triple
    is bit-identical to ``boruvka(gs.graphs[g])`` on every backend.
    ``mesh=`` runs on the wave engine."""
    if mesh is not None:
        comp_flat, in_mst_flat, rounds, _ = distributed_boruvka_forest(
            mesh, gs.union(), capacity=capacity, axis=axis, spec=spec,
            max_subrounds=max_subrounds, batch=gs.axis)
    else:
        comp_flat, in_mst_flat, rounds = boruvka_forest(
            gs.union(), spec=spec, axis_width=gs.num_graphs)
    comps = gs.split_vertex(comp_flat)
    sels = gs.split_edge(in_mst_flat)
    out = []
    for i, g in enumerate(gs.graphs):
        weight, n_edges = _dedupe_mst_pairs(g, sels[i].to(g.device))
        out.append((comps[i] - int(gs.voffs[i]), weight, n_edges))
    return out, rounds


def distributed_boruvka_forest(mesh, g: Graph, *, capacity: int = 4096,
                               m: int | None = None, axis: str = "data",
                               spec: C.CommitSpec | None = None,
                               max_subrounds: int = 64, batch=None,
                               snapshot_rounds: int | None = None,
                               fault_injector=None):
    """The distributed contraction loop behind :func:`distributed_boruvka`
    and the graph-batched entry point.  Returns (comp [V], in_mst bool [E]
    in the original edge order, rounds, DistributedResult); ``batch`` is
    the run's batch axis.  ``snapshot_rounds``/``fault_injector`` run it
    in degraded-mesh mode, where a shrink restarts it from round 0 (its
    per-edge selection cannot be re-homed)."""
    dev = mesh.device
    v, e_tot = g.num_vertices, g.num_edges
    jump = max(int(v).bit_length(), 1)

    def init(g, layout):
        return {"comp": torch.arange(layout.vpad, dtype=torch.int32,
                                     device=dev),
                "in_mst": torch.zeros((layout.num_shards * layout.emax,),
                                      dtype=torch.bool, device=dev)}, {}

    def round_fn(rt, e, st, sc, it):
        comp, in_mst = st["comp"], st["in_mst"]
        gid = rt.gid
        block = comp.shape[0]
        cs = comp[e.my_src]
        cd = rt.gather(comp, e.dst, e.valid, fill=0)
        cross = e.valid & (cs != cd)
        # lexicographic (weight, edge id) minimum per component: two MF
        # min waves into the component owners, as the single-shard
        # two-pass argmin
        bw, _ = rt.wave(torch.full((block,), INF, dtype=torch.float32,
                                   device=dev), cs, e.weight, cross,
                        op="min")
        bwcs = rt.gather(bw, cs, cross, fill=INF)
        cand = cross & (e.weight == bwcs) & (bwcs < INF)
        be, _ = rt.wave(torch.full((block,), e_tot, dtype=torch.int32,
                                   device=dev), cs, e.eid, cand, op="min")
        becs = rt.gather(be, cs, cand, fill=e_tot)
        winner = cand & (e.eid == becs)
        in_mst = in_mst | winner
        # hook: the root of cs points at the component of the chosen dst
        # (one winner per component, a min wave into empty slots)
        hook, _ = rt.wave(torch.full((block,), HOOK_EMPTY, dtype=torch.int32,
                                     device=dev), cs, cd, winner, op="min")
        parent = torch.where(hook < HOOK_EMPTY, hook, gid)
        # break mutual pairs (a <-> b): the larger id becomes a root
        gp = rt.gather(parent, parent)
        parent = torch.where((gp == gid) & (gid > parent), gid, parent)
        # pointer jumping through the FR read path (log V remote gathers)
        for _ in range(jump):
            parent = rt.gather(parent, parent)
        new_comp = rt.gather(parent, comp)
        changed = rt.any(new_comp != comp)
        return {"comp": new_comp, "in_mst": in_mst}, sc, changed

    alg = AlgorithmSpec("boruvka", "FR&MF", init, round_fn,
                        lambda g, layout: jump + 1)
    parts = partition_tensors(g, mesh.shape[axis])   # shared with the engine
    res = run_distributed(alg, mesh, g, capacity=capacity, m=m, axis=axis,
                          spec=spec, max_subrounds=max_subrounds,
                          edges=parts, batch=batch,
                          snapshot_rounds=snapshot_rounds,
                          fault_injector=fault_injector)
    comp = res.state["comp"][:v]
    # map the shard slots' selections back to original edge ids, in the
    # layout the run finished on (a degraded run ends on fewer shards)
    if res.shards != mesh.shape[axis]:
        parts = partition_tensors(g, res.shards)
    (_, _, _, valid, eid), _ = parts
    slots = res.state["in_mst"].reshape(valid.shape)
    sel = torch.zeros((e_tot,), dtype=torch.bool, device=dev)
    sel[eid[valid].long()] = slots[valid]
    return comp, sel, res.rounds, res


def distributed_boruvka(mesh, g: Graph, *, capacity: int = 4096,
                        m: int | None = None, axis: str = "data",
                        spec: C.CommitSpec | None = None,
                        max_subrounds: int = 64, telemetry: bool = False,
                        snapshot_rounds: int | None = None,
                        fault_injector=None):
    """Boruvka MST on the wave engine, FR&MF rounds: two ``min`` waves
    select each component's lexicographically least outgoing edge
    (weight, then original edge id, so ties break as in the single-shard
    run), a hook wave writes the component pointers, and pointer jumping
    contracts the forest through remote gathers.

    Returns (comp [V], weight, n_edges, rounds); ``telemetry=True``
    appends the DistributedResult.  ``snapshot_rounds``/``fault_injector``
    run it in degraded-mesh mode (see
    :func:`repro_torch.core.engine.run_distributed`)."""
    comp, sel, rounds, res = distributed_boruvka_forest(
        mesh, g, capacity=capacity, m=m, axis=axis, spec=spec,
        max_subrounds=max_subrounds, snapshot_rounds=snapshot_rounds,
        fault_injector=fault_injector)
    weight, n_edges = _dedupe_mst_pairs(g, sel.to(g.device))
    out = (comp, weight, n_edges, rounds)
    return telemetry_return(out, res, telemetry)


def mst_reference(g: Graph) -> float:
    """Oracle (tests): the minimum spanning forest's weight by SciPy's
    Kruskal, each undirected pair taking the least weight of its stored
    directions; summed in float64."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree
    v = g.num_vertices
    src = g.src.cpu().numpy().astype(np.int64)
    dst = g.dst.cpu().numpy().astype(np.int64)
    w = g.weights.cpu().numpy().astype(np.float64)
    keep = src != dst
    lo = np.minimum(src, dst)[keep]
    hi = np.maximum(src, dst)[keep]
    w = w[keep]
    order = np.lexsort((w, hi, lo))         # by pair, then least weight
    lo, hi, w = lo[order], hi[order], w[order]
    first = np.ones(len(lo), bool)
    first[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    if (w[first] <= 0).any():
        raise ValueError("mst_reference needs positive weights (SciPy reads "
                         "a zero as no edge)")
    forest = minimum_spanning_tree(coo_matrix(
        (w[first], (lo[first], hi[first])), shape=(v, v)).tocsr())
    return float(forest.sum())
