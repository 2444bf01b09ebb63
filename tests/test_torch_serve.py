"""The port's graph service (``repro_torch.serve.graph_service``) against
the reference package's on the CPU.

* The same submission stream through ``repro.serve.graph_service`` (on
  ``atomic``) and the port's service (on each of its four backends), on
  the lane, graph and product axes, all of them mixed, and the mixed
  stream with ``product=False``: every answer equal (integers, ``min``
  results, bools and components bit for bit, PPR and MST weights within
  rtol 2e-4 / atol 1e-6), the row dtypes equal, and every
  ``ServiceStats`` counter but ``drain_s``/``last_drain_s`` equal.
* Admission and bookkeeping, each script run on both services with the
  same outcome: the cache and in-flight dedup, re-registration
  invalidation and voided tickets, a registration deferred to the drain
  boundary, out-of-range vertices, bounded retention, chunking above
  the ladders, a ``fault_injector`` crash mid-drain re-queueing its
  queries under their original tickets.
* ``_same_topology`` compares on the graph's device and agrees with the
  reference's host compare; a fake clock gives exact ``drain_s`` with
  two clock reads per drain.
* The ``mesh=`` route at world size 1 against the reference's
  ``make_host_mesh(1, 1)`` service for BFS and st-connectivity.
"""
import numpy as np
import pytest
import torch

from repro.core.commit import CommitSpec as JSpec
from repro.graphs import generators as JG
from repro.serve import graph_service as JS
from repro.serve import queries as JQ
from repro_torch.convert import to_graph
from repro_torch.core.commit import CommitSpec as TSpec
from repro_torch.serve import graph_service as TS
from repro_torch.serve import queries as TQ

ADD_RTOL, ADD_ATOL = 2e-4, 1e-6
BACKENDS = ("atomic", "coarse", "pallas", "fused")
TIMING = ("drain_s", "last_drain_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each
    (a worker's default of one thread per core makes the port's small
    ops several times slower under the suite's load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tuner_files(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "off")
    monkeypatch.delenv("REPRO_TRACE", raising=False)


def _port(g):
    return to_graph(*(np.asarray(a) for a in
                      (g.indptr, g.src, g.dst, g.weights)),
                    g.num_vertices, device="cpu")


def _tenants():
    """A hot power-law graph and three uniform tenants (32-48 vertices),
    weighted for SSSP and MST."""
    gs = {"hot": JG.kronecker(5, 6, seed=3)}
    for i in range(3):
        gs[f"t{i}"] = JG.erdos_renyi(30 + 6 * i, 4.0, seed=i)
    return {gid: JG.random_weights(g, seed=i)
            for i, (gid, g) in enumerate(gs.items())}


_GRAPHS = _tenants()


def _pair(jspec=None, tspec=None, graphs=None, **kw):
    """(reference service, port service) over the same graphs."""
    ref = JS.GraphService(spec=jspec or JSpec(backend="atomic",
                                              stats=False), **kw)
    port = TS.GraphService(spec=tspec or TSpec(backend="atomic",
                                               stats=False), **kw)
    for gid, g in (graphs or _GRAPHS).items():
        ref.register_graph(gid, g)
        port.register_graph(gid, _port(g))
    return ref, port


def assert_row(got, want, kind="bfs", what=""):
    """A port result row against a reference row: bools, MST triples
    (components bit for bit, the weight within the float-add tolerance)
    and arrays of equal dtype, bit for bit but for PPR's float ``add``
    rows."""
    if isinstance(want, bool):
        assert type(got) is bool and got == want, what
        return
    if isinstance(want, tuple):
        comp, w, n = got
        np.testing.assert_array_equal(np.asarray(comp),
                                      np.asarray(want[0]), err_msg=what)
        assert np.asarray(comp).dtype == np.asarray(want[0]).dtype
        np.testing.assert_allclose(float(w), float(want[1]), rtol=ADD_RTOL,
                                   atol=ADD_ATOL, err_msg=what)
        assert int(n) == int(want[2]), what
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if kind == "ppr":
        np.testing.assert_allclose(got, want, rtol=ADD_RTOL, atol=ADD_ATOL,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def assert_stats(port, ref):
    for f in JS.ServiceStats._COUNTERS:
        if f not in TIMING:
            assert getattr(port.stats, f) == getattr(ref.stats, f), f


# -- the same stream on every axis -----------------------------------------


def _stream(name, Q):
    """[(graph_id, query)] of one stream, in the package ``Q``'s query
    classes."""
    if name == "lane":
        return ([("hot", Q.BfsQuery(s)) for s in (1, 5, 9)]
                + [("hot", Q.SsspQuery(s)) for s in (1, 5, 9, 2, 3)]
                + [("hot", Q.PprQuery(s, iters=5)) for s in (1, 5)]
                + [("hot", Q.StConnQuery(s, 20)) for s in (1, 5)]
                + [("hot", Q.BfsQuery(5))])               # deduped
    if name == "graph":
        return [(f"t{i}", q) for i in range(3) for q in (
            Q.BfsQuery(i), Q.SsspQuery(i + 1), Q.PprQuery(i, iters=5),
            Q.StConnQuery(0, i + 3), Q.ColoringQuery(seed=1),
            Q.MstQuery())]
    if name == "product":
        return ([("hot", Q.BfsQuery(s)) for s in (1, 5, 9)]
                + [(f"t{i}", Q.BfsQuery(i)) for i in range(3)]
                + [("hot", Q.SsspQuery(s)) for s in (2, 4)]
                + [(f"t{i}", Q.SsspQuery(i + 2)) for i in range(2)]
                + [("hot", Q.PprQuery(s, iters=5)) for s in (1, 5)]
                + [("t2", Q.PprQuery(7, iters=5))]
                + [("hot", Q.StConnQuery(s, 20)) for s in (1, 5)]
                + [(f"t{i}", Q.StConnQuery(0, i + 6)) for i in range(3)])
    # mixed: every axis in one drain
    return (_stream("lane", Q) + _stream("graph", Q)
            + [("t1", Q.BfsQuery(1)), ("t0", Q.ColoringQuery(seed=1))])


STREAMS = {"lane": {}, "graph": {"max_graphs": 2},
           "product": {"max_lanes": 2}, "mixed": {},
           "two_axis": {"product": False}}
_REF_RUNS = {}


def _ref_run(name):
    """The reference service's drain of a stream (memoised per module:
    its waves compile once)."""
    if name not in _REF_RUNS:
        kw = dict(max_lanes=4, max_graphs=4)
        kw.update(STREAMS[name])
        ref = JS.GraphService(spec=JSpec(backend="atomic", stats=False),
                              **kw)
        for gid, g in _GRAPHS.items():
            ref.register_graph(gid, g)
        stream = _stream("mixed" if name == "two_axis" else name, JQ)
        tickets = [ref.submit(gid, q) for gid, q in stream]
        done = ref.drain()
        _REF_RUNS[name] = (ref, tickets, sorted(done))
    return _REF_RUNS[name]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("stream", list(STREAMS))
def test_stream_parity(stream, backend):
    ref, rtickets, rdone = _ref_run(stream)
    kw = dict(max_lanes=4, max_graphs=4)
    kw.update(STREAMS[stream])
    port = TS.GraphService(spec=TSpec(backend=backend, stats=False), **kw)
    for gid, g in _GRAPHS.items():
        port.register_graph(gid, _port(g))
    sub = _stream("mixed" if stream == "two_axis" else stream, TQ)
    tickets = [port.submit(gid, q) for gid, q in sub]
    done = port.drain()
    assert tickets == rtickets and sorted(done) == rdone
    assert port.pending() == 0
    for t, (gid, q) in zip(tickets, sub):
        assert_row(port.result(t), ref.result(t), q.kind,
                   f"{stream} {gid} {q}")
        row = port.result(t)
        if isinstance(row, torch.Tensor):
            assert row.shape == (_GRAPHS[gid].num_vertices,)
    assert_stats(port, ref)
    if stream == "product":
        assert port.stats.product_waves > 0
    if stream == "two_axis":
        assert port.stats.product_waves == 0 and port.stats.waves > 0


# -- admission and bookkeeping, one script on both services -------------------


def _twin(script, **kw):
    """Run ``script(svc, Q)`` on the reference and the port service and
    return both outcomes."""
    ref, port = _pair(**kw)
    return script(ref, JQ), script(port, TQ), ref, port


def test_cache_and_inflight_dedup():
    def script(svc, Q):
        t1 = svc.submit("hot", Q.BfsQuery(2))
        t2 = svc.submit("hot", Q.BfsQuery(2))        # in-flight duplicate
        assert svc.pending() == 1
        svc.drain()
        t3 = svc.submit("hot", Q.BfsQuery(2))        # cache hit
        assert svc.pending() == 0
        return [svc.result(t) for t in (t1, t2, t3)]
    r, p, ref, port = _twin(script, max_lanes=4)
    for a, b in zip(p, r):
        assert_row(a, b)
    assert port.stats.deduped == 1 and port.stats.cache_hits == 1
    assert port.stats.waves == 1 and port.stats.lanes_executed == 1
    assert_stats(port, ref)


def test_reregister_invalidates_cache_and_inflight():
    g_old = JG.random_weights(JG.kronecker(6, 4, seed=1), seed=0)
    g_new = JG.random_weights(JG.kronecker(6, 4, seed=42), seed=0)

    def script(svc, Q):
        conv = (lambda g: g) if Q is JQ else _port
        svc.register_graph("g", conv(g_old))
        svc.run("g", [Q.BfsQuery(0)])                # populates the cache
        t_inflight = svc.submit("g", Q.BfsQuery(3))
        svc.register_graph("g", conv(g_new))
        assert svc.stats.invalidated == 1
        with pytest.raises(KeyError):
            svc.result(t_inflight)                   # voided forever
        t = svc.submit("g", Q.BfsQuery(0))           # not a stale hit
        assert svc.stats.cache_hits == 0
        svc.drain()
        svc.register_graph("g", conv(g_new))         # same topology
        svc.submit("g", Q.BfsQuery(0))
        assert svc.stats.cache_hits == 1 and svc.stats.invalidated == 1
        return svc.result(t)
    r, p, ref, port = _twin(script, max_lanes=2)
    assert_row(p, r)
    assert_stats(port, ref)


def test_same_topology_compares_on_device_like_the_reference():
    a = JG.kronecker(6, 4, seed=1)
    b = JG.kronecker(6, 4, seed=42)
    w = JG.random_weights(a, seed=3)
    for x, y in ((a, a), (a, b), (a, w), (a, JG.kronecker(5, 4, seed=1)),
                 (a, JG.kronecker(6, 4, seed=1))):
        assert TS._same_topology(_port(x), _port(y)) == \
            JS._same_topology(x, y)


def test_register_graph_mid_drain_defers_to_boundary():
    """A re-registration during a drain lands at the drain boundary: the
    in-progress queries answer on the graph they were admitted under,
    then the boundary's invalidation sweep purges the new rows."""
    g = JG.erdos_renyi(50, 4.0, seed=1)
    h = JG.erdos_renyi(40, 4.0, seed=2)
    g_new = JG.erdos_renyi(50, 5.0, seed=7)

    def script(svc, Q):
        conv = (lambda x: x) if Q is JQ else _port
        new = conv(g_new)
        svc.register_graph("g", conv(g))
        svc.register_graph("h", conv(h))
        seen = {}

        def reg(where, i):
            if i == 0:
                svc.register_graph("g", new)
                seen["deferred"] = svc._graphs["g"] is not new
        svc.fault_injector = reg
        ts = [svc.submit("g", Q.BfsQuery(3)), svc.submit("g", Q.BfsQuery(4)),
              svc.submit("h", Q.BfsQuery(1))]
        done = svc.drain()
        assert seen["deferred"] and svc._graphs["g"] is new
        assert all(t in done for t in ts)
        assert not any(k[0] == "g" for k in svc._cache)
        assert any(k[0] == "h" for k in svc._cache)
        svc.fault_injector = None
        return [svc.result(t) for t in ts] + svc.run("g", [Q.BfsQuery(3)])
    r, p, ref, port = _twin(script, graphs={})
    for a, b in zip(p, r):
        assert_row(a, b)
    assert_stats(port, ref)


def test_new_graph_id_registers_immediately_mid_drain():
    fresh = _port(JG.erdos_renyi(20, 3.0, seed=9))
    _, port = _pair()

    def reg(where, i):
        if i == 0:
            port.register_graph("new", fresh)
    port.fault_injector = reg
    port.submit("hot", TQ.BfsQuery(0))
    port.drain()
    assert port._graphs["new"] is fresh


def test_out_of_range_vertices_and_unknown_graphs_rejected():
    def script(svc, Q):
        v = _GRAPHS["hot"].num_vertices
        out = []
        for q in (Q.BfsQuery(v), Q.StConnQuery(0, -1), Q.PprQuery(v + 3)):
            with pytest.raises(ValueError):
                svc.submit("hot", q)
        with pytest.raises(KeyError):
            svc.submit("nope", Q.BfsQuery(0))
        t = svc.submit("hot", Q.BfsQuery(v - 1))     # boundary ok
        with pytest.raises(KeyError):
            svc.result(t)                            # not drained yet
        svc.drain()
        out.append(svc.result(t))
        return out
    r, p, ref, port = _twin(script)
    assert_row(p[0], r[0])
    assert_stats(port, ref)


def test_bounded_retention():
    def script(svc, Q):
        tickets = [svc.submit("hot", Q.BfsQuery(i)) for i in range(6)]
        svc.drain()
        assert len(svc._results) == 3 and len(svc._cache) == 2
        with pytest.raises(KeyError):
            svc.result(tickets[0])                   # oldest evicted
        return [svc.result(t) for t in tickets[3:]]
    r, p, ref, port = _twin(script, max_lanes=2, max_results=3, max_cache=2)
    for a, b in zip(p, r):
        assert_row(a, b)
    assert_stats(port, ref)


def test_ladders_chunking_and_validation():
    def script(svc, Q):
        out = svc.run("hot", [Q.BfsQuery(i) for i in range(5)])
        for i in range(5):
            svc.submit(f"t{i % 3}", Q.SsspQuery(i))
        svc.drain()
        return out
    r, p, ref, port = _twin(script, max_lanes=2, max_graphs=2,
                            product=False)
    for a, b in zip(p, r):
        assert_row(a, b)
    # bfs 2 + 2 + 1 lanes; sssp one lane wave per tenant (2, 2, 1)
    assert port.stats.waves == 3 + 3 and port.stats.lanes_executed == 10
    assert_stats(port, ref)
    assert TS._pow2_ladder(8) == JS._pow2_ladder(8) == (1, 2, 4, 8)
    for bad in (dict(max_lanes=6), dict(max_graphs=3)):
        with pytest.raises(ValueError):
            TS.GraphService(**bad)


def test_fault_mid_drain_requeues_under_original_tickets():
    """A wave raising mid-drain re-queues every unfinished query under
    its original tickets; the retry answers each ticket once."""
    def script(svc, Q):
        fired = {"n": 0}

        def crash(where, i):
            if i == 1 and not fired["n"]:
                fired["n"] += 1
                raise RuntimeError("host lost")
        svc.fault_injector = crash
        ts = [svc.submit("hot", Q.BfsQuery(s)) for s in (0, 1, 2)]
        ts += [svc.submit("hot", Q.PprQuery(s, iters=4)) for s in (0, 3)]
        ts += [svc.submit(f"t{i}", Q.ColoringQuery()) for i in range(2)]
        with pytest.raises(RuntimeError, match="host lost"):
            svc.drain()
        queued = sorted(t for lanes in svc._queue.values()
                        for tickets in lanes.values() for t in tickets)
        done = svc.drain()
        assert sorted(set(queued)) == queued
        assert sorted(done) == queued
        return queued, [svc.result(t) for t in ts]
    (rq, rrows), (pq, prows), ref, port = _twin(script, max_lanes=4)
    assert pq == rq and pq
    for a, b, kind in zip(prows, rrows, ["bfs"] * 3 + ["ppr"] * 2
                          + ["coloring"] * 2):
        assert_row(a, b, kind)
    assert_stats(port, ref)


class SteppingClock:
    """Every read advances 250 ms."""

    def __init__(self):
        self.now, self.reads = 100.0, 0

    def __call__(self):
        self.now += 0.25
        self.reads += 1
        return self.now


def test_fake_clock_gives_exact_drain_time():
    clk = SteppingClock()
    _, port = _pair(clock=clk)
    port.submit("hot", TQ.BfsQuery(0))
    r0 = clk.reads
    port.drain()
    assert clk.reads - r0 == 2             # t0 and the finally block
    assert port.stats.drains == 1
    assert port.stats.last_drain_s == pytest.approx(0.25)
    port.submit("hot", TQ.BfsQuery(1))
    port.drain()
    assert port.stats.drains == 2
    assert port.stats.drain_s == pytest.approx(0.5)


@pytest.mark.parametrize("backend", ("coarse", "fused"))
def test_mesh_route_world_size_1_matches_reference(backend):
    from repro.launch.mesh import make_host_mesh
    from repro_torch.launch.mesh import make_mesh

    def script(svc, Q):
        return svc.run("hot", [Q.BfsQuery(0), Q.BfsQuery(7), Q.BfsQuery(9),
                               Q.StConnQuery(0, 9), Q.StConnQuery(3, 30)])
    ref = JS.GraphService(spec=JSpec(backend="coarse", stats=False),
                          max_lanes=2, mesh=make_host_mesh(1, 1),
                          capacity="auto")
    port = TS.GraphService(spec=TSpec(backend=backend, stats=False),
                           max_lanes=2, mesh=make_mesh(device="cpu"),
                           capacity="auto")
    ref.register_graph("hot", _GRAPHS["hot"])
    port.register_graph("hot", _port(_GRAPHS["hot"]))
    for a, b in zip(script(port, TQ), script(ref, JQ)):
        assert_row(a, b)
    assert_stats(port, ref)
    assert port.stats.waves == 3 and port.stats.product_waves == 0
