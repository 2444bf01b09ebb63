"""Lanes×graphs product waves — resumable, insertable AAM execution.

Port of :mod:`repro.serve.product_wave`.  A :class:`ProductWave` runs ONE
fused wave over the :class:`repro_torch.core.coalescing.ProductAxis`: up
to L queries over EACH graph of a
:class:`repro_torch.graphs.csr.GraphSet`.  State is lane-major over the
union key space (``[L, Vtot]``; composite commit keys
``lane * Vtot + offset[g] + v``), so a (lane, graph) CELL is an
independent work item — the hot tenant's three BFS queries and five
single-query tenants drain as one commit stream instead of a lane wave
plus a graph wave.

Two properties make it the serving substrate for continuous batching:

* **resumable** — rounds execute in chunks of ``round_chunk``; between
  chunks the host owns the state;
* **insertable** — an empty (padding or freed) cell admits a NEW query
  mid-run by splicing its initial state at a round boundary
  (:meth:`insert`); disjoint flat key ranges mean the late cell's
  per-round arithmetic is exactly what an idle run would do, so its
  answer is bit-identical (float ``add`` to rounding) no matter at which
  round it boarded.

Per-cell completion (:meth:`cell_done`, or :meth:`done_cells` for every
cell in one host read) lets a drain loop harvest and free finished cells
while stragglers keep the wave warm.  Whole-graph kinds (coloring, MST)
have no lane form and stay on the graph batch axis — ``PRODUCT_KINDS``
names what can ride here.

Differences from the reference: each chunk is a host loop of rounds with
one host read a round (the reference's ``lax.while_loop``), and the
state is updated in place at :meth:`insert`/:meth:`release`, so
:meth:`extract` returns a copy of the cell's row.
:func:`lint_traceables` exposes the chunk bodies alone, as state-only
callables, to :mod:`repro_torch.analysis.waverace`; since the port's
rounds run eagerly, its example states carry an inserted query in every
cell, so that one round runs.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from repro_torch.core import autotune as AT
from repro_torch.core import commit as C
from repro_torch.core.coalescing import ProductAxis
from repro_torch.core.messages import product_messages
from repro_torch.graphs.csr import GraphSet, segment_sum
from repro_torch.serve.queries import PRODUCT_KINDS

INT_INF = 2 ** 30
F32_INF = 3.0e38

# full-run chunk limit: round loops are frontier/rem-bounded, the limit
# only guards the loop
_RUN_ALL = 1 << 30

_OPS = {"bfs": "min", "sssp": "min", "ppr": "add", "stconn": "or"}


def _per_graph(x, gov, num_graphs: int):
    """[rows, Vt] -> [rows, G] sums over each graph's vertex range."""
    return segment_sum(x.T, gov, num_graphs).T


def _dist_chunk(g, axis, state, step, limit, weighted):
    """BFS/SSSP product rounds: FF&MF ``min`` relaxation over the union,
    every lane at once.  Cells converge independently (empty frontier);
    extra rounds cannot move a converged cell (min is monotone and
    components are disjoint)."""
    lanes, vt = axis.lanes, axis.num_vertices
    dst_b = g.dst.expand(lanes, g.num_edges)
    st = dict(state)
    it = 0
    live = bool(st["frontier"].any())
    while live and it < limit:
        dist = st["dist"]
        active = st["frontier"][:, g.src]
        pay = dist[:, g.src] + (g.weights[None, :] if weighted else 1)
        msgs = product_messages(dst_b, pay, active, axis)
        res, lvl = step(dist.reshape(-1), msgs, st["lvl"])
        dist2 = res.state.reshape(lanes, vt)
        st = dict(st, dist=dist2, frontier=dist2 != dist, lvl=lvl)
        it += 1
        live = bool(st["frontier"].any())
    return st, not live, it


def _ppr_chunk(g, axis, gov, egov, deg, dangling, d, state, step, limit):
    """Personalized-PageRank product rounds: FF&AS ``add`` waves with a
    per-CELL iteration budget ``rem`` [L, G] (a cell inserted at round k
    still runs its full ``iters`` rounds while earlier cells stop on
    their own schedule) and per-cell dangling mass (segment sums by the
    graph-of-vertex map, one per lane)."""
    lanes, vt = axis.lanes, axis.num_vertices
    ng = axis.num_graphs
    dst_b = g.dst.expand(lanes, g.num_edges)
    acc0 = torch.zeros((lanes * vt,), dtype=torch.float32, device=g.device)
    gov_l = gov.long()
    st = dict(state)
    it = 0
    live = bool((st["rem"] > 0).any())
    while live and it < limit:
        rank = st["rank"]
        alive = st["rem"] > 0                               # [L, G]
        contrib = d * rank[:, g.src] / deg[g.src][None, :]
        msgs = product_messages(dst_b, contrib, alive[:, egov], axis)
        res, lvl = step(acc0, msgs, st["lvl"])
        dm = _per_graph(torch.where(dangling[None, :], rank, 0.0), gov,
                        ng)                                 # [L, G]
        rank2 = st["restart"] * ((1.0 - d) + d * dm[:, gov_l]) \
            + res.state.reshape(lanes, vt)
        alive_v = alive[:, gov_l]                           # [L, Vt]
        st = dict(st, rank=torch.where(alive_v, rank2, rank),
                  rem=st["rem"] - alive.to(torch.int32), lvl=lvl)
        it += 1
        live = bool((st["rem"] > 0).any())
    return st, not live, it


def _stconn_live(st, gov):
    quiet = torch.repeat_interleave(~st["found"], 2, dim=0)   # [2L, G]
    return st["frontier"] & quiet[:, gov.long()]


def _stconn_chunk(g, axis, gov, egov, state, step, limit):
    """s-t connectivity product rounds: query cell (l, g) runs its two
    BFS marks as PAIRED lanes 2l (grey) / 2l+1 (green) of the product
    axis — the same 2-mark nesting ``_union_stconn`` proves, one level
    up.  ``found`` is [L, G] (per-cell segment reduction of the
    mark-meet by graph); answered cells go quiet."""
    l2, vt = axis.lanes, axis.num_vertices        # axis.lanes == 2L
    ng = axis.num_graphs
    dst_b = g.dst.expand(l2, g.num_edges)
    egov_l = egov.long()
    st = dict(state)
    it = 0
    live = bool(_stconn_live(st, gov).any())
    while live and it < limit:
        marks = st["marks"]
        quiet_e = torch.repeat_interleave(~st["found"], 2, dim=0)[:, egov_l]
        active = st["frontier"][:, g.src] & quiet_e
        msgs = product_messages(dst_b, active.to(torch.int32), active, axis)
        res, lvl = step(marks.reshape(-1), msgs, st["lvl"])
        marks2 = res.state.reshape(l2, vt)
        frontier2 = (marks2 != 0) & (marks == 0)
        meet = (marks2[0::2] != 0) & (marks2[1::2] != 0)    # [L, Vt]
        found2 = st["found"] | (_per_graph(meet.to(torch.int32), gov,
                                           ng) > 0)
        st = dict(st, marks=marks2, frontier=frontier2, found=found2,
                  lvl=lvl)
        it += 1
        live = bool(_stconn_live(st, gov).any())
    return st, not live, it


class ProductWave:
    """One resumable lanes×graphs wave over a GraphSet.

    ``lanes`` is the lane budget L (cells per graph); stconn internally
    doubles the axis (paired mark lanes) but its cell coordinates are
    still (lane < L, graph).  ``fuse`` carries the kind's wave-wide knobs
    (ppr: ``{"iters": .., "d": ..}``) — queries sharing the wave must
    share them (the service's fuse-key grouping guarantees it).  The
    wave lives on the set's device.
    """

    def __init__(self, kind: str, gs: GraphSet, lanes: int, *,
                 spec: C.CommitSpec | None = None, fuse: dict | None = None,
                 round_chunk: int = 4):
        if kind not in PRODUCT_KINDS:
            raise ValueError(f"kind {kind!r} has no lane form — serve it "
                             f"on the graph batch axis")
        self.kind = kind
        self.gs = gs
        self.lanes = int(lanes)
        self.spec = spec if spec is not None \
            else C.CommitSpec(backend="coarse", stats=False)
        self.fuse = dict(fuse or {})
        self.round_chunk = int(round_chunk)
        width = 2 * self.lanes if kind == "stconn" else self.lanes
        self.axis = ProductAxis(width, gs.axis.sizes)
        self.g = gs.union()
        self._gov = gs.graph_of_vertex()
        self._egov = gs.graph_of_edge()
        self.occupied = np.zeros((self.lanes, gs.num_graphs), bool)
        self.rounds = 0
        self.done = True                 # empty wave has nothing to run
        dev = self.g.device
        vt = self.axis.num_vertices
        op = _OPS[kind]
        dtype = torch.float32 if kind in ("sssp", "ppr") else torch.int32
        lvl_state = types.SimpleNamespace(shape=(self.axis.flat_size,),
                                          dtype=dtype, device=dev)
        _, lvl0 = AT.make_commit_step(self.spec, op, lvl_state,
                                      n=self.axis.flat_size,
                                      axis_width=self.axis.race_width)
        # the chunks' commit step, resolved once per wave (the reference
        # resolves it once per traced chunk shape)
        self._step, _ = AT.make_commit_step(
            self.spec, op, lvl_state,
            n=width * self.g.num_edges, axis_width=self.axis.race_width,
            label=f"product:{'dist' if op == 'min' else kind}")
        if kind in ("bfs", "sssp"):
            self.state = {
                "dist": torch.full((width, vt), INT_INF if kind == "bfs"
                                   else F32_INF, dtype=dtype, device=dev),
                "frontier": torch.zeros((width, vt), dtype=torch.bool,
                                        device=dev),
                "lvl": lvl0}
        elif kind == "ppr":
            self.state = {
                "rank": torch.zeros((width, vt), dtype=torch.float32,
                                    device=dev),
                "restart": torch.zeros((width, vt), dtype=torch.float32,
                                       device=dev),
                "rem": torch.zeros((width, gs.num_graphs),
                                   dtype=torch.int32, device=dev),
                "lvl": lvl0}
            self._deg = self.g.degrees.clamp(min=1).to(torch.float32)
            self._dangling = self.g.degrees == 0
        else:                            # stconn
            self.state = {
                "marks": torch.zeros((width, vt), dtype=torch.int32,
                                     device=dev),
                "frontier": torch.zeros((width, vt), dtype=torch.bool,
                                        device=dev),
                "found": torch.zeros((self.lanes, gs.num_graphs),
                                     dtype=torch.bool, device=dev),
                "lvl": lvl0}

    # -- cell lifecycle ---------------------------------------------------

    def _range(self, graph: int) -> tuple[int, int]:
        return int(self.gs.voffs[graph]), int(self.gs.voffs[graph + 1])

    def free_cell(self, graph: int) -> int | None:
        """Lowest free lane slot in column ``graph`` (None = full)."""
        for lane in range(self.lanes):
            if not self.occupied[lane, graph]:
                return lane
        return None

    def insert(self, lane: int, graph: int, query) -> None:
        """Claim cell (lane, graph) for ``query`` and splice its initial
        state — legal at ANY round boundary, including round 0 of an
        idle wave and round k of a running one (the continuous-batching
        insert)."""
        if self.occupied[lane, graph]:
            raise ValueError(f"cell ({lane}, {graph}) is occupied")
        off = int(self.gs.voffs[graph])
        st = self.state
        if self.kind in ("bfs", "sssp"):
            src = off + int(query.source)
            st["dist"][lane, src] = 0
            st["frontier"][lane, src] = True
        elif self.kind == "ppr":
            src = off + int(query.source)
            st["rank"][lane, src] = 1.0
            st["restart"][lane, src] = 1.0
            st["rem"][lane, graph] = int(query.iters)
        else:                            # stconn: paired mark lanes
            s, t = off + int(query.s), off + int(query.t)
            st["marks"][2 * lane, s] = 1
            st["marks"][2 * lane + 1, t] = 1
            st["frontier"][2 * lane, s] = True
            st["frontier"][2 * lane + 1, t] = True
            st["found"][lane, graph] = int(query.s) == int(query.t)
        self.occupied[lane, graph] = True
        self.done = False

    def done_cells(self) -> np.ndarray:
        """bool [L, G]: occupied cells that have converged, every cell in
        one device reduction and one host read (what :meth:`cell_done`
        answers cell by cell).  Monotone kinds cannot un-converge — a
        done cell's answer is final even while the wave keeps running
        for the stragglers."""
        st = self.state
        ng = self.gs.num_graphs
        if self.kind == "ppr":
            done = st["rem"] == 0
        else:
            frontier = st["frontier"]
            if self.kind == "stconn":
                frontier = frontier.reshape(self.lanes, 2, -1).any(1)
            busy = _per_graph(frontier.to(torch.int32), self._gov, ng) > 0
            done = ~busy
            if self.kind == "stconn":
                done = done | st["found"]
        return done.cpu().numpy() & self.occupied

    def cell_done(self, lane: int, graph: int) -> bool:
        """Has cell (lane, graph) converged?"""
        if not self.occupied[lane, graph]:
            return False
        lo, hi = self._range(graph)
        st = self.state
        if self.kind in ("bfs", "sssp"):
            return not bool(st["frontier"][lane, lo:hi].any())
        if self.kind == "ppr":
            return int(st["rem"][lane, graph]) == 0
        if bool(st["found"][lane, graph]):
            return True
        return not bool(st["frontier"][2 * lane:2 * lane + 2,
                                       lo:hi].any())

    def extract(self, lane: int, graph: int):
        """The cell's result row (same row types the service caches): a
        copy, which a later :meth:`release` or :meth:`insert` of the cell
        cannot change."""
        lo, hi = self._range(graph)
        st = self.state
        if self.kind in ("bfs", "sssp"):
            return st["dist"][lane, lo:hi].clone()
        if self.kind == "ppr":
            return st["rank"][lane, lo:hi].clone()
        return bool(st["found"][lane, graph])

    def release(self, lane: int, graph: int) -> None:
        """Reset cell (lane, graph) to empty so a later :meth:`insert`
        can reuse the slot mid-run (the continuous loop's harvest)."""
        lo, hi = self._range(graph)
        st = self.state
        if self.kind in ("bfs", "sssp"):
            st["dist"][lane, lo:hi] = INT_INF if self.kind == "bfs" \
                else F32_INF
            st["frontier"][lane, lo:hi] = False
        elif self.kind == "ppr":
            st["rank"][lane, lo:hi] = 0.0
            st["restart"][lane, lo:hi] = 0.0
            st["rem"][lane, graph] = 0
        else:
            st["marks"][2 * lane:2 * lane + 2, lo:hi] = 0
            st["frontier"][2 * lane:2 * lane + 2, lo:hi] = False
            st["found"][lane, graph] = False
        self.occupied[lane, graph] = False
        if not self.occupied.any():
            self.done = True

    # -- execution --------------------------------------------------------

    def _run(self, limit: int) -> bool:
        if self.kind in ("bfs", "sssp"):
            st, done, it = _dist_chunk(self.g, self.axis, self.state,
                                       self._step, limit,
                                       self.kind == "sssp")
        elif self.kind == "ppr":
            st, done, it = _ppr_chunk(
                self.g, self.axis, self._gov, self._egov, self._deg,
                self._dangling, float(self.fuse.get("d", 0.85)),
                self.state, self._step, limit)
        else:
            st, done, it = _stconn_chunk(self.g, self.axis, self._gov,
                                         self._egov, self.state,
                                         self._step, limit)
        self.state = st
        self.rounds += it
        self.done = done
        return self.done

    def run_chunk(self, rounds: int | None = None) -> bool:
        """Execute up to ``rounds`` (default ``round_chunk``) rounds;
        returns True when no live work remains.  The gap between chunks
        is the ROUND BOUNDARY where :meth:`insert`/:meth:`release` are
        legal."""
        if self.done:
            return True
        return self._run(int(rounds or self.round_chunk))

    def run(self) -> int:
        """Run to completion (the synchronous drain path); returns total
        rounds executed."""
        if not self.done:
            self._run(_RUN_ALL)
        return self.rounds


def lint_traceables(*, lanes: int = 2, sizes=(5, 7), seed: int = 0,
                    spec: C.CommitSpec | None = None, device="cuda"):
    """``(name, fn_of_state, example_state)`` triples exposing each
    product-chunk round body to :mod:`repro_torch.analysis.waverace`.

    The returned callables take ONLY the chunk's state dict — graph
    arrays, governor maps, and degree vectors are closed over, so the
    analyzer can seed its state chain from exactly the state's tensors.
    Each runs its chunk at ``limit=1`` with a concrete spec (default
    ``atomic``; ``auto`` is refused, as no calibration may run inside a
    check), on a wave with one query inserted in every cell."""
    from repro_torch import resolve_device
    from repro_torch.graphs.generators import erdos_renyi, random_weights
    from repro_torch.serve.queries import (BfsQuery, PprQuery, SsspQuery,
                                           StConnQuery)
    device = resolve_device(device)
    spec = spec if spec is not None \
        else C.CommitSpec(backend="atomic", stats=False)
    if spec.backend == C.AUTO:
        raise ValueError("lint_traceables takes a static spec, not 'auto'")
    gs = GraphSet([
        random_weights(erdos_renyi(int(s), avg_degree=3.0, seed=seed + i,
                                   device=device), seed=i)
        for i, s in enumerate(sizes)])
    queries = {"bfs": lambda lane, n: BfsQuery(lane % n),
               "sssp": lambda lane, n: SsspQuery(lane % n),
               "ppr": lambda lane, n: PprQuery(lane % n, iters=2),
               "stconn": lambda lane, n: StConnQuery(lane % n,
                                                     (lane + 1) % n)}
    out = []
    for kind in PRODUCT_KINDS:
        pw = ProductWave(kind, gs, lanes, spec=spec)
        for lane in range(lanes):
            for graph, n in enumerate(sizes):
                pw.insert(lane, graph, queries[kind](lane, int(n)))
        if kind in ("bfs", "sssp"):
            fn = (lambda st, pw=pw, w=(kind == "sssp"):
                  _dist_chunk(pw.g, pw.axis, st, pw._step, 1, w)[0])
        elif kind == "ppr":
            fn = (lambda st, pw=pw:
                  _ppr_chunk(pw.g, pw.axis, pw._gov, pw._egov, pw._deg,
                             pw._dangling, 0.85, st, pw._step, 1)[0])
        else:
            fn = (lambda st, pw=pw:
                  _stconn_chunk(pw.g, pw.axis, pw._gov, pw._egov, st,
                                pw._step, 1)[0])
        out.append((f"product_wave/{kind}", fn, pw.state))
    return out
