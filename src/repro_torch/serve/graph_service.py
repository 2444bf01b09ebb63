"""Graph query service — batch-axis multi-tenant serving of AAM queries.

Port of :mod:`repro.serve.graph_service`: the same admission, axes,
ladders, cache and statistics over the port's entry points.

The paper's waves amortize per-message overhead by coalescing many active
messages into one transaction; at serving scale the same move applies one
level up, along TWO orthogonal batch axes
(``repro_torch.core.coalescing``):

* **query lanes** — many independent queries over ONE graph fuse into
  lanes of a single wave (composite commit keys ``lane * V + v``);
* **graph batch** — the same query kind over MANY tenant graphs fuses
  into one wave over the disjoint-union flat key space
  (``offset[g] + v``) — the axis that makes coloring and Boruvka
  servable at all (their rounds share no lane structure, but
  independent graphs trivially share a wave);
* **product axis** — their composition (``lane * Vtot + offset[g] + v``,
  :class:`repro_torch.core.coalescing.ProductAxis`): MANY queries over
  MANY graphs in ONE wave, so a mixed tenant load (one hot graph with
  several queries + a tail of single-query tenants) drains as a single
  commit stream instead of a lane wave plus a graph batch
  (:mod:`repro_torch.serve.product_wave`; asynchronous continuous
  batching on top lives in :mod:`repro_torch.serve.continuous`).

The service owns the non-wave half of serving:

* **admission / axis choice** — submitted queries queue per
  (graph, fuse key); ``drain()`` picks the fusion axis per fuse-key
  group: graphs holding SEVERAL queries of a kind fuse them as lanes
  (at most ``max_lanes``, lane count padded up a power-of-two ladder),
  graphs holding ONE query each fuse across graphs as a graph batch (at
  most ``max_graphs``, graph count padded up its own ladder) — the
  power-of-two ladder applied per axis keeps the wave shapes to
  ``log2(width)+1`` per kind; padding repeats a real query/graph and is
  discarded;
* **in-flight dedup** — identical queries submitted before a drain share
  one lane;
* **result cache** — keyed by ``(graph_id, query)``; hits answer at
  submit time without touching the card.  Re-registering a ``graph_id``
  with different topology invalidates that graph's cache entries AND its
  in-flight queue (stale tickets raise KeyError forever) instead of
  serving answers computed on the old graph;
* **telemetry** — :class:`ServiceStats` counts what the ladders and
  cache actually saved.

Execution is the batch-axis algorithm entry points (``multi_source_*``
for lanes, ``batched_over_graphs_*`` for graph batches); pass ``mesh=``
(a :class:`repro_torch.launch.mesh.Mesh`) to serve from the wave engine
instead of the single-shard loops.  A wave runs on its graphs' device;
:meth:`GraphService.restore` takes the device to restore onto.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.core import autotune as AT
from repro_torch.core import commit as C
from repro_torch.obs import trace as OT
from repro_torch.obs import wavetap as OW
from repro_torch.serve.queries import (QUERY_KINDS, GRAPH_ONLY_KINDS,
                                       PRODUCT_KINDS)


class ServiceStats:
    """What the batching layer did (not wave-level telemetry — that lives
    in CommitResult/DistributedResult).

    A thin attribute view over a
    :class:`repro_torch.obs.metrics.Registry` —
    ``stats.waves += 1`` increments the ``aam_waves`` counter, so one
    store backs both the historical attribute surface and the
    Prometheus/JSON exports (``stats.registry.prometheus_text()`` /
    ``stats.registry.snapshot()``).  The continuous server's
    submit-to-answer latency histogram lives in the same registry.
    """

    # counter fields (ints; drain_s is a float counter)
    _COUNTERS = (
        "submitted",
        "cache_hits",
        "deduped",           # submissions that joined an in-flight lane
        "waves",             # fused lane waves executed
        "lanes_executed",    # total lanes across waves (incl. padding)
        "lanes_padded",      # ladder-padding lanes (discarded results)
        "graph_waves",       # fused graph-batch waves executed
        "graphs_batched",    # graphs across graph waves (incl. padding)
        "graphs_padded",     # ladder-padding graphs (discarded results)
        "invalidated",       # in-flight tickets voided by re-registration
        "timing_runs",       # autotune timed micro-benchmarks drains paid
        #                      (a warm-restored service asserts it stays 0)
        "product_waves",     # fused lanes×graphs product waves executed
        "product_cells",     # (lane, graph) cells across product waves
        "product_cells_padded",  # empty cells (no query) in those waves
        # drain timing — read through the service's injected clock, so a
        # fake-clock test sees deterministic values (no wall-clock flake)
        "drains",
        "drain_s",           # total time inside drain()
    )
    _GAUGES = ("last_drain_s",)

    def __init__(self, registry=None):
        from repro_torch.obs import metrics as OM
        reg = registry if registry is not None else OM.Registry()
        object.__setattr__(self, "registry", reg)
        for f in self._COUNTERS:
            reg.counter("aam_" + f)
        for f in self._GAUGES:
            reg.gauge("aam_" + f)

    def __getattr__(self, name):
        if name in self._COUNTERS:
            return self.registry.counter("aam_" + name).value
        if name in self._GAUGES:
            return self.registry.gauge("aam_" + name).value
        raise AttributeError(f"{type(self).__name__!r} object has no "
                             f"attribute {name!r}")

    def __setattr__(self, name, value):
        if name in self._COUNTERS:
            self.registry.counter("aam_" + name).set(value)
        elif name in self._GAUGES:
            self.registry.gauge("aam_" + name).set(value)
        else:
            object.__setattr__(self, name, value)

    @property
    def total_waves(self) -> int:
        """Waves of ANY axis (lane + graph + product) — the denominator
        dashboards actually want."""
        return self.waves + self.graph_waves + self.product_waves

    def __repr__(self) -> str:
        fields = ", ".join(f"{f}={getattr(self, f)!r}"
                           for f in self._COUNTERS + self._GAUGES)
        return f"ServiceStats({fields})"


def _pow2_ladder(width: int) -> tuple:
    """(1, 2, 4, ..., width) — the per-axis wave-shape ladder."""
    ladder = []
    w = 1
    while w < width:
        ladder.append(w)
        w *= 2
    return tuple(ladder) + (width,)


def _same_topology(a, b) -> bool:
    """Do two Graphs have identical topology/weights?  (The
    re-registration staleness check — cheap shape gate first, then a
    compare on ``a``'s device: no edge array is copied to the host.)"""
    if a is b:
        return True
    if (a.num_vertices, a.num_edges) != (b.num_vertices, b.num_edges):
        return False
    dev = a.device
    return all(torch.equal(x, y.to(dev)) for x, y in
               ((a.src, b.src), (a.dst, b.dst), (a.weights, b.weights)))


class GraphService:
    """Serve streams of independent graph queries as fused batch-axis
    waves: same-graph requests as query lanes, same-kind requests across
    tenant graphs as graph batches (see the module docstring).

    spec:       CommitSpec for every fused commit.  None (default) serves
                with ``CommitSpec(backend="auto", sort=False,
                stats=False)`` — the calibrated mechanism tier minus the
                sorted ``coarse`` path, which pays an L-times-larger
                argsort on every fused wave (mostly over masked-out
                lanes once queries start converging), which a single
                all-valid micro-race can mistakenly favor; the scatter
                and kernel tiers stay in the race.  Pass a concrete spec to
                pin the mechanism.
    max_lanes:  lane budget L of one fused wave (power of two).
    max_graphs: graph budget G of one graph-batch wave (power of two).
    mesh:       optional :class:`repro_torch.launch.mesh.Mesh` — execute
                on the wave engine over its shards instead of the
                single-shard loops.
    capacity:   coalescing factor for distributed execution ("auto" =
                telemetry-sized, see
                ``repro_torch.core.engine.auto_capacity``).
    cache:      keep a ``(graph_id, query) -> result`` cache.
    max_results / max_cache: retention bounds (FIFO eviction) — a serving
                daemon must not hold every [V] result row it ever
                produced; ``result()`` raises KeyError for tickets older
                than the last ``max_results``.
    product:    fuse mixed-shape fuse-key groups (several graphs, some
                holding several queries) as ONE lanes×graphs product
                wave (:mod:`repro_torch.serve.product_wave`) instead of
                a lane wave per multi-query graph plus a graph batch for
                the singles.  Single-shard only; mesh services keep the
                two-axis drain.
    clock:      0-arg callable returning seconds (default
                ``time.perf_counter``) — every timing stat reads THIS
                clock, so tests inject a fake clock and assert exact
                values instead of flaking on wall time.
    tracer:     a :class:`repro_torch.obs.trace.Tracer` for span export.
                None (default): with an injected ``clock`` the service binds
                a private tracer to that same clock (deterministic span
                timestamps under a fake clock); otherwise it shares the
                process-global tracer, so every service of one
                continuous-batching run lands in ONE trace.  Inert
                unless tracing is enabled (``REPRO_TRACE=1`` or an
                explicitly-enabled tracer).
    """

    def __init__(self, *, spec: C.CommitSpec | None = None,
                 max_lanes: int = 8, max_graphs: int = 8, mesh=None,
                 capacity: int | str = "auto", axis: str = "data",
                 cache: bool = True, max_results: int = 4096,
                 max_cache: int = 1024, product: bool = True,
                 clock=None, tracer=None):
        if max_lanes < 1 or (max_lanes & (max_lanes - 1)):
            raise ValueError(f"max_lanes must be a power of two, got "
                             f"{max_lanes}")
        if max_graphs < 1 or (max_graphs & (max_graphs - 1)):
            raise ValueError(f"max_graphs must be a power of two, got "
                             f"{max_graphs}")
        self.spec = spec if spec is not None \
            else C.CommitSpec(backend="auto", sort=False, stats=False)
        if OT.trace_enabled() and not self.spec.trace:
            # promote the wave telemetry tap into every fused commit's
            # spec — the entry points and ProductWave chunks all tap
            self.spec = dataclasses.replace(self.spec, trace=True)
        self.max_lanes = max_lanes
        self.max_graphs = max_graphs
        self.lane_ladder = _pow2_ladder(max_lanes)
        self.graph_ladder = _pow2_ladder(max_graphs)
        self.mesh = mesh
        self.capacity = capacity
        self.axis = axis
        self.max_results = max_results
        self.max_cache = max_cache
        self.product = product
        self.clock = clock if clock is not None else time.perf_counter
        if tracer is not None:
            self.tracer = tracer
        elif clock is not None:
            self.tracer = OT.Tracer(clock=self.clock)
        else:
            self.tracer = OT.get_tracer()
        self.stats = ServiceStats()
        self._graphs: dict[Any, Any] = {}
        # (graph_id tuple) -> GraphSet memo: the union arrays are built
        # once across drains of a stable tenant mix
        self._graphsets: dict[tuple, Any] = {}
        # (graph_id, fuse_key) -> {query: [tickets]} in arrival order
        self._queue: dict[tuple, dict] = {}
        self._results: dict[int, Any] = {}
        self._cache: dict | None = {} if cache else None
        self._next_ticket = 0
        # (kind, graph_id) -> last adaptive transaction size M the mesh
        # harness converged to (0 = whole batch); seeds the next wave's
        # conflict ladder and rides the service snapshot so a restored
        # service re-enters at the learned level
        self._m_learned: dict[tuple, int] = {}
        # fault injection (tests / crash-resume bench): callable
        # (where, wave_index) raising to simulate a crash mid-drain
        self.fault_injector = None
        self._wave_i = 0
        # re-registrations arriving while a drain is executing are
        # DEFERRED to the drain boundary (see register_graph)
        self._drain_depth = 0
        self._deferred_regs: list = []

    @staticmethod
    def _bounded_put(d: dict, key, value, bound: int) -> None:
        """Insert with FIFO eviction (python dicts iterate insertion
        order) so long-running services hold O(bound) result rows."""
        d[key] = value
        while len(d) > bound:
            d.pop(next(iter(d)))

    # -- admission --------------------------------------------------------

    def register_graph(self, graph_id, g) -> None:
        """Register a graph under ``graph_id`` (the tenant key).

        Re-registering an id with DIFFERENT topology invalidates every
        ``(graph_id, query)`` result-cache entry and drops the graph's
        in-flight queue — their tickets raise KeyError forever (counted
        in ``stats.invalidated``) — so no answer computed on the old
        topology is ever served.  Same-topology re-registration is a
        no-op for the cache.

        Re-registering an EXISTING id while a drain is executing (the
        async continuous loop, or a fault injector calling back into the
        service mid-drain) defers the swap to the drain/wave boundary:
        applying it immediately would purge the cache only for the
        in-progress wave's ``finish`` to re-cache rows computed on the
        old topology, and would void queue entries the drain's crash
        handler is about to merge back.  The in-progress wave answers
        against the graph its queries were admitted under; the new
        topology (and its invalidation sweep) takes effect before the
        next wave is built.  Brand-new ids register immediately — no
        in-flight state can refer to them."""
        if self._drain_depth > 0 and graph_id in self._graphs:
            self._deferred_regs.append((graph_id, g))
            return
        old = self._graphs.get(graph_id)
        if old is not None and not _same_topology(old, g):
            if self._cache is not None:
                for k in [k for k in self._cache if k[0] == graph_id]:
                    del self._cache[k]
            for qk in [qk for qk in self._queue if qk[0] == graph_id]:
                for tickets in self._queue.pop(qk).values():
                    self.stats.invalidated += len(tickets)
        if old is not None:
            # the union memo interns the old arrays — rebuild on demand
            for k in [k for k in self._graphsets if graph_id in k]:
                del self._graphsets[k]
        self._graphs[graph_id] = g

    def _apply_deferred_regs(self) -> None:
        """Apply re-registrations that arrived mid-drain (always called
        at the drain boundary with ``_drain_depth`` back at 0 — the
        point where cache purge + ticket voiding are race-free)."""
        regs, self._deferred_regs = self._deferred_regs, []
        for graph_id, g in regs:
            self.register_graph(graph_id, g)

    def _graphset(self, graph_ids: tuple):
        from repro_torch.graphs.csr import GraphSet
        gs = self._graphsets.get(graph_ids)
        if gs is None:
            gs = GraphSet([self._graphs[gid] for gid in graph_ids])
            self._bounded_put(self._graphsets, graph_ids, gs, 32)
        return gs

    def submit(self, graph_id, query) -> int:
        """Enqueue one query; returns a ticket for :meth:`result`.

        Cache hits resolve immediately; identical in-flight queries share
        a lane (the ticket still gets its own result entry).  Vertex ids
        are validated here — an out-of-range source would be silently
        DROPPED by the commit (an all-INF answer, then cached), so
        admission is the error boundary."""
        if graph_id not in self._graphs:
            raise KeyError(f"unknown graph_id {graph_id!r}; "
                           f"register_graph first")
        if query.kind not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {query.kind!r}")
        v = self._graphs[graph_id].num_vertices
        if query.kind == "stconn":
            ids = (query.s, query.t)
        elif query.kind in GRAPH_ONLY_KINDS:
            ids = ()                      # whole-graph queries name no vertex
        else:
            ids = (query.source,)
        for i in ids:
            if not 0 <= int(i) < v:
                raise ValueError(f"{query} names vertex {i} outside "
                                 f"[0, {v}) of graph {graph_id!r}")
        ticket = self._next_ticket
        self._next_ticket += 1
        self.stats.submitted += 1
        ck = (graph_id, query)
        if self._cache is not None and ck in self._cache:
            self.stats.cache_hits += 1
            self._bounded_put(self._results, ticket, self._cache[ck],
                              self.max_results)
            self.tracer.instant("submit", args={"ticket": ticket,
                                                "kind": query.kind,
                                                "cache_hit": True})
            return ticket
        lanes = self._queue.setdefault((graph_id, query.fuse_key()), {})
        if query in lanes:
            self.stats.deduped += 1
        lanes.setdefault(query, []).append(ticket)
        self.tracer.instant("submit", args={"ticket": ticket,
                                            "kind": query.kind,
                                            "cache_hit": False})
        return ticket

    def _replay_submit(self, graph_id, query, ticket: int) -> None:
        """Re-enter an already-acknowledged submission under its ORIGINAL
        ticket id (snapshot-restore WAL replay).  Idempotent: tickets that
        already have a result (or are already queued) are left alone."""
        self._next_ticket = max(self._next_ticket, ticket + 1)
        if ticket in self._results:
            return
        ck = (graph_id, query)
        if self._cache is not None and ck in self._cache:
            self._bounded_put(self._results, ticket, self._cache[ck],
                              self.max_results)
            return
        lanes = self._queue.setdefault((graph_id, query.fuse_key()), {})
        tickets = lanes.setdefault(query, [])
        if ticket not in tickets:
            tickets.append(ticket)

    def pending(self) -> int:
        """Distinct queries waiting for the next :meth:`drain`."""
        return sum(len(q) for q in self._queue.values())

    def result(self, ticket: int):
        """The answer for ``ticket`` (KeyError until drained)."""
        return self._results[ticket]

    # -- execution --------------------------------------------------------

    def drain(self) -> dict:
        """Execute every queued query in fused batch-axis waves.

        Per fuse-key group the fusion axis is chosen here: a MIXED group
        — several graphs, at least one holding several queries — fuses
        as ONE lanes×graphs PRODUCT wave (``product=True``, single-shard
        only); otherwise graphs holding SEVERAL distinct queries of the
        kind lane-fuse them (one wave per graph, ``multi_source_*``) and
        graphs holding ONE query each fuse ACROSS graphs as a graph
        batch (``batched_over_graphs_*``) — whole-graph kinds (coloring,
        MST) only have the graph axis.  Returns {ticket: result} for
        everything completed by this call.

        Crash safety: a wave raising mid-drain (device fault, injected
        crash) re-queues every not-yet-finished query — with its original
        tickets — before the exception propagates, so a retry or a
        restore-and-replay never loses an acknowledged submission."""
        done: dict[int, Any] = {}
        queues, self._queue = self._queue, {}
        # queries not finished yet — merged back on a mid-drain fault
        remaining = {k: dict(v) for k, v in queues.items()}
        t0_timing = AT.DEFAULT_TUNER.timed_runs
        t0 = self.clock()
        by_fuse: dict[tuple, list] = {}
        for (graph_id, fk), lanes in queues.items():
            by_fuse.setdefault(fk, []).append((graph_id, lanes))

        def finish(graph_id, q, row):
            if self._cache is not None:
                self._bounded_put(self._cache, (graph_id, q), row,
                                  self.max_cache)
            for t in queues[(graph_id, q.fuse_key())][q]:
                self._bounded_put(self._results, t, row, self.max_results)
                done[t] = row
            remaining[(graph_id, q.fuse_key())].pop(q, None)

        self._drain_depth += 1
        try:
            for fk, entries in by_fuse.items():
                kind = fk[0]
                if (self.product and self.mesh is None
                        and kind in PRODUCT_KINDS and len(entries) >= 2
                        and any(len(lanes) > 1 for _, lanes in entries)):
                    # product axis: many queries × many graphs, one wave
                    for gid, q, row in self._execute_product(kind,
                                                             entries):
                        finish(gid, q, row)
                    continue
                singles = [(gid, next(iter(lanes)))
                           for gid, lanes in entries if len(lanes) == 1]
                multis = [(gid, lanes) for gid, lanes in entries
                          if len(lanes) > 1]
                if len(singles) >= 2 or (singles
                                         and kind in GRAPH_ONLY_KINDS):
                    # graph axis: one query per graph, chunked by
                    # max_graphs
                    for lo in range(0, len(singles), self.max_graphs):
                        chunk = singles[lo:lo + self.max_graphs]
                        with self.tracer.span(
                                "wave", args={"axis": "graph",
                                              "kind": kind,
                                              "graphs": len(chunk)}):
                            rows = self._execute_graph_batch(kind, chunk)
                        for (gid, q), row in zip(chunk, rows):
                            finish(gid, q, row)
                else:
                    multis += [(gid, {q: queues[(gid, fk)][q]})
                               for gid, q in singles]
                for graph_id, lanes in multis:
                    # lane axis: many queries, one graph
                    g = self._graphs[graph_id]
                    queries = list(lanes)
                    for lo in range(0, len(queries), self.max_lanes):
                        chunk = queries[lo:lo + self.max_lanes]
                        with self.tracer.span(
                                "wave", args={"axis": "lane", "kind": kind,
                                              "queries": len(chunk)}):
                            rows = self._execute_wave(g, chunk,
                                                      graph_id=graph_id)
                        for q, row in zip(chunk, rows):
                            finish(graph_id, q, row)
        except Exception:
            for key, lanes in remaining.items():
                if not lanes:
                    continue
                tgt = self._queue.setdefault(key, {})
                for q, tickets in lanes.items():
                    tgt.setdefault(q, []).extend(
                        t for t in tickets if t not in tgt.get(q, ()))
            raise
        finally:
            self._drain_depth -= 1
            if self._drain_depth == 0:
                self._apply_deferred_regs()
            self.stats.timing_runs += AT.DEFAULT_TUNER.timed_runs \
                - t0_timing
            dt = self.clock() - t0
            self.stats.drains += 1
            self.stats.drain_s += dt
            self.stats.last_drain_s = dt
            if self.tracer.active:
                # reuse t0/dt — the drain span adds ZERO clock reads
                # (a fake-clock test pins drain() to exactly two)
                self.tracer.complete("drain", t0, dt,
                                     args={"done": len(done),
                                           "waves": self.stats.waves,
                                           "graph_waves":
                                           self.stats.graph_waves,
                                           "product_waves":
                                           self.stats.product_waves})
                OW.flush_to(self.tracer)
        return done

    def _fault(self, where: str) -> None:
        """Fault-injection hook: called before every wave with a running
        wave index; the injector raising simulates a crash mid-drain."""
        i = self._wave_i
        self._wave_i += 1
        if self.fault_injector is not None:
            self.fault_injector(where, i)

    def _spec_for(self, kind: str, graph_id) -> C.CommitSpec:
        """The commit spec for one wave: the service spec, seeded with
        the learned ladder M when serving ``backend="auto"`` and a
        previous mesh wave on this (kind, graph) reported its converged
        transaction size."""
        if self.spec.backend != C.AUTO or self.spec.m is not None:
            return self.spec
        m = self._m_learned.get((kind, graph_id))
        if m is None:
            return self.spec
        return dataclasses.replace(self.spec, seed_m=m)

    def _learn_m(self, kind: str, graph_id, res) -> None:
        """Record the adaptive ladder's final M from a mesh wave's
        telemetry (-1 = static spec, nothing to learn)."""
        m = int(res.m_final)
        if m >= 0:
            self._m_learned[(kind, graph_id)] = m

    def _execute_graph_batch(self, kind: str, chunk: list) -> list:
        """One graph-batch wave: ``chunk`` is [(graph_id, query)], one
        per graph; pad the graph count up the graph ladder, execute the
        ``batched_over_graphs_*`` entry point, return one result row per
        real (graph, query) pair."""
        self._fault("graph_batch")
        k = len(chunk)
        width = next(w for w in self.graph_ladder if w >= k)
        padded = chunk + [chunk[-1]] * (width - k)
        self.stats.graph_waves += 1
        self.stats.graphs_batched += width
        self.stats.graphs_padded += width - k
        gs = self._graphset(tuple(gid for gid, _ in padded))
        qs = [q for _, q in padded]
        kw = dict(spec=self.spec, mesh=self.mesh, capacity=self.capacity,
                  axis=self.axis)
        if kind == "bfs":
            from repro_torch.graphs.algorithms.bfs import \
                batched_over_graphs_bfs
            rows = batched_over_graphs_bfs(gs, [q.source for q in qs], **kw)
        elif kind == "sssp":
            from repro_torch.graphs.algorithms.sssp import \
                batched_over_graphs_sssp
            rows = batched_over_graphs_sssp(gs, [q.source for q in qs],
                                            **kw)
        elif kind == "ppr":
            from repro_torch.graphs.algorithms.pagerank import \
                batched_over_graphs_pagerank
            rows = batched_over_graphs_pagerank(
                gs, [q.source for q in qs], iters=qs[0].iters, d=qs[0].d,
                **kw)
        elif kind == "stconn":
            from repro_torch.graphs.algorithms.stconn import \
                batched_over_graphs_stconn
            found = batched_over_graphs_stconn(
                gs, [q.s for q in qs], [q.t for q in qs], **kw)
            rows = found.tolist()           # one host read
        elif kind == "coloring":
            from repro_torch.graphs.algorithms.coloring import \
                batched_over_graphs_coloring
            rows, _, _ = batched_over_graphs_coloring(
                gs, seed=qs[0].seed, max_rounds=qs[0].max_rounds, **kw)
        else:   # mst
            from repro_torch.graphs.algorithms.boruvka import \
                batched_over_graphs_boruvka
            rows, _ = batched_over_graphs_boruvka(gs, **kw)
        return list(rows)[:k]

    def _execute_product(self, kind: str, entries: list) -> list:
        """Lanes×graphs product waves for one fuse-key group:
        ``entries`` is [(graph_id, {query: tickets})] spanning several
        graphs with mixed per-graph query counts.  Graphs chunk by
        ``max_graphs``; the lane budget of each wave is the ladder width
        of the deepest graph in the chunk (capped at ``max_lanes``;
        deeper columns board follow-up waves).  Returns
        [(graph_id, query, row)] for every real cell — empty cells are
        padding, executed and discarded like ladder lanes."""
        from repro_torch.serve.product_wave import ProductWave
        out = []
        for lo in range(0, len(entries), self.max_graphs):
            chunk = entries[lo:lo + self.max_graphs]
            gids = tuple(gid for gid, _ in chunk)
            gs = self._graphset(gids)
            per_graph = [list(lanes) for _, lanes in chunk]
            depth = max(len(qs) for qs in per_graph)
            width = next(w for w in self.lane_ladder
                         if w >= min(depth, self.max_lanes))
            q0 = per_graph[0][0]
            fuse = {"iters": q0.iters, "d": q0.d} if kind == "ppr" else {}
            for r in range(0, depth, width):
                self._fault("product")
                wave = ProductWave(kind, gs, width, spec=self.spec,
                                   fuse=fuse)
                cells = []
                for gi, qs in enumerate(per_graph):
                    for li, q in enumerate(qs[r:r + width]):
                        wave.insert(li, gi, q)
                        cells.append((gi, li, q))
                self.stats.product_waves += 1
                self.stats.product_cells += width * len(chunk)
                self.stats.product_cells_padded += \
                    width * len(chunk) - len(cells)
                with self.tracer.span(
                        "wave", args={"axis": "product", "kind": kind,
                                      "lanes": width,
                                      "graphs": len(chunk),
                                      "cells": len(cells)}):
                    wave.run()
                for gi, li, q in cells:
                    out.append((gids[gi], q, wave.extract(li, gi)))
        return out

    def run(self, graph_id, queries) -> list:
        """Convenience: submit all, drain, return results in order."""
        tickets = [self.submit(graph_id, q) for q in queries]
        self.drain()
        return [self._results[t] for t in tickets]

    def _execute_wave(self, g, chunk: list, *, graph_id=None) -> list:
        """One fused wave: pad ``chunk`` up the lane ladder, execute,
        return one result row per real query.

        Mesh waves run with telemetry so the adaptive ladder's converged
        M is learned per (kind, graph) — seeding the NEXT wave's ladder
        (and, through the snapshot, the first wave after a restore) at
        the learned level.  The single-shard loops do not expose their
        final ladder level, so learning is mesh-path only."""
        self._fault("wave")
        k = len(chunk)
        lanes = next(l for l in self.lane_ladder if l >= k)
        padded = chunk + [chunk[-1]] * (lanes - k)
        self.stats.waves += 1
        self.stats.lanes_executed += lanes
        self.stats.lanes_padded += lanes - k
        kind = chunk[0].kind
        spec = self._spec_for(kind, graph_id)
        dev = g.device
        if kind == "bfs":
            srcs = torch.tensor([q.source for q in padded],
                                dtype=torch.int32, device=dev)
            if self.mesh is not None:
                from repro_torch.graphs.algorithms.bfs import \
                    distributed_multi_source_bfs
                dist, _, res = distributed_multi_source_bfs(
                    self.mesh, g, srcs, spec=spec,
                    capacity=self.capacity, axis=self.axis, telemetry=True)
                self._learn_m(kind, graph_id, res)
            else:
                from repro_torch.graphs.algorithms.bfs import \
                    multi_source_bfs
                dist = multi_source_bfs(g, srcs, spec=spec).dist
            return [dist[i] for i in range(k)]
        if kind == "sssp":
            srcs = torch.tensor([q.source for q in padded],
                                dtype=torch.int32, device=dev)
            if self.mesh is not None:
                from repro_torch.graphs.algorithms.sssp import \
                    distributed_multi_source_sssp
                dist, _, res = distributed_multi_source_sssp(
                    self.mesh, g, srcs, spec=spec,
                    capacity=self.capacity, axis=self.axis, telemetry=True)
                self._learn_m(kind, graph_id, res)
            else:
                from repro_torch.graphs.algorithms.sssp import \
                    multi_source_sssp
                dist, _ = multi_source_sssp(g, srcs, spec=spec)
            return [dist[i] for i in range(k)]
        if kind == "ppr":
            srcs = torch.tensor([q.source for q in padded],
                                dtype=torch.int32, device=dev)
            iters, d = chunk[0].iters, chunk[0].d
            if self.mesh is not None:
                from repro_torch.graphs.algorithms.pagerank import \
                    distributed_multi_source_pagerank
                rank, res = distributed_multi_source_pagerank(
                    self.mesh, g, srcs, iters=iters, d=d, spec=spec,
                    capacity=self.capacity, axis=self.axis, telemetry=True)
                self._learn_m(kind, graph_id, res)
            else:
                from repro_torch.graphs.algorithms.pagerank import \
                    multi_source_pagerank
                rank, _ = multi_source_pagerank(g, srcs, iters=iters, d=d,
                                                spec=spec)
            return [rank[i] for i in range(k)]
        # stconn
        ss = torch.tensor([q.s for q in padded], dtype=torch.int32,
                          device=dev)
        ts = torch.tensor([q.t for q in padded], dtype=torch.int32,
                          device=dev)
        if self.mesh is not None:
            from repro_torch.graphs.algorithms.stconn import \
                distributed_multi_source_stconn
            found, _, res = distributed_multi_source_stconn(
                self.mesh, g, ss, ts, spec=spec,
                capacity=self.capacity, axis=self.axis, telemetry=True)
            self._learn_m(kind, graph_id, res)
        else:
            from repro_torch.graphs.algorithms.stconn import \
                multi_source_stconn
            found, _ = multi_source_stconn(g, ss, ts, spec=spec)
        return found[:k].tolist()           # one host read

    # -- durability -------------------------------------------------------

    def snapshot(self):
        """Freeze the warm state of this service into a
        :class:`repro_torch.serve.durable.ServiceSnapshot`: registered
        graphs, result cache, issued results, the in-flight ticket
        journal, learned ladder levels, and the autotuner's calibration
        fits."""
        from repro_torch.serve.durable import build_snapshot
        return build_snapshot(self)

    @classmethod
    def restore(cls, snap, *, mesh=None, clock=None, device="cuda"):
        """Rebuild a WARM service from a snapshot: same config, graphs,
        cache, pending queue (original tickets), learned M levels, and
        imported autotune fits — the first drain runs zero timed
        calibrations and commits at the learned transaction size.
        Graphs and result rows land on ``device``.  ``mesh`` re-attaches
        distributed execution and ``clock`` the injected timebase (both
        are process resources and do not serialize)."""
        from repro_torch.serve.durable import restore_service
        return restore_service(snap, mesh=mesh, clock=clock,
                               device=device)
