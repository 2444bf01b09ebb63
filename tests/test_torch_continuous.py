"""The port's continuous-batching loop (``repro_torch.serve.continuous``)
against the reference package's on the CPU.

* ``DeadlineAdmission``: the same sequences of ``note``/``due``/
  ``remaining``/``reset`` give the reference's answers.
* In-flight submission parity, one query per product kind: a query
  submitted while the loop is mid-drain answers as the reference's idle
  service does (bit for bit; PPR within rtol 2e-4 / atol 1e-6), and a
  query boards the running product wave (one product wave in all).
* Racing submitter threads with kills mid-wave under a
  ``ServiceSupervisor``: every ticket is answered exactly once, each
  answer equal to the reference's two-axis run of that query.
* A cache-hit-only cycle counts as a zero-length drain.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

from repro.core.commit import CommitSpec as JSpec
from repro.graphs import generators as JG
from repro.serve import continuous as JC
from repro.serve import graph_service as JS
from repro.serve import queries as JQ
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.convert import to_graph
from repro_torch.core.commit import CommitSpec as TSpec
from repro_torch.serve import continuous as TC
from repro_torch.serve import graph_service as TS
from repro_torch.serve import queries as TQ
from repro_torch.serve.durable import ServiceSupervisor

ADD_RTOL, ADD_ATOL = 2e-4, 1e-6


@pytest.fixture(autouse=True)
def _no_tuner_files(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "off")
    monkeypatch.delenv("REPRO_TRACE", raising=False)


def _port(g):
    return to_graph(*(np.asarray(a) for a in
                      (g.indptr, g.src, g.dst, g.weights)),
                    g.num_vertices, device="cpu")


def _graphs():
    gs = {"hot": JG.kronecker(5, 6, seed=3)}
    for i in range(2):
        gs[f"t{i}"] = JG.erdos_renyi(30 + 8 * i, 4.0, seed=i)
    return {gid: JG.random_weights(g, seed=4) for gid, g in gs.items()}


_GRAPHS = _graphs()


def _eq(kind, got, want):
    if kind == "stconn":
        assert type(got) is bool and got == want
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    if kind == "ppr":
        np.testing.assert_allclose(got, want, rtol=ADD_RTOL, atol=ADD_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


# -- deadline admission -----------------------------------------------------


def test_admission_matches_reference():
    rng = np.random.default_rng(0)
    for trial in range(20):
        wait = float(rng.uniform(0.0, 1.0))
        cap = int(rng.integers(1, 6))
        ja, ta = JC.DeadlineAdmission(wait, cap), TC.DeadlineAdmission(wait,
                                                                       cap)
        now = 0.0
        for _ in range(30):
            now += float(rng.uniform(0.0, 0.4))
            op = rng.integers(4)
            if op == 0:
                ja.note(now)
                ta.note(now)
            elif op == 1:
                pending = int(rng.integers(0, 8))
                assert ta.due(now, pending) == ja.due(now, pending)
            elif op == 2:
                assert ta.remaining(now) == ja.remaining(now)
            else:
                ja.reset()
                ta.reset()
            assert ta.deadline == ja.deadline


# -- in-flight insertion ----------------------------------------------------


def _probe(kind, v, Q):
    return {"bfs": Q.BfsQuery(v // 3), "sssp": Q.SsspQuery(v // 3),
            "ppr": Q.PprQuery(v // 3, iters=6),
            "stconn": Q.StConnQuery(1, v - 2)}[kind]


_IDLE = {}


def _idle_answer(kind):
    if kind not in _IDLE:
        idle = JS.GraphService(spec=JSpec(backend="atomic", stats=False),
                               cache=False)
        for gid, g in _GRAPHS.items():
            idle.register_graph(gid, g)
        v = _GRAPHS["t1"].num_vertices
        _IDLE[kind] = idle.run("t1", [_probe(kind, v, JQ)])[0]
    return _IDLE[kind]


@pytest.mark.parametrize("kind", ("bfs", "sssp", "ppr", "stconn"))
def test_inflight_submission_parity(kind):
    """The probe lands while the loop drains a product wave of hot-graph
    lanes and tenant work (the wave's first chunk waits for it); it
    answers as the reference's idle service.  A late hot-graph BFS
    boards the running wave: one product wave in all, the probe on the
    synchronous axes after it."""
    svc = TS.GraphService(spec=TSpec(backend="fused", stats=False),
                          cache=False)
    for gid, g in _GRAPHS.items():
        svc.register_graph(gid, _port(g))
    started, go = threading.Event(), threading.Event()

    def hold(where, i):
        if where == "continuous" and not started.is_set():
            started.set()
            go.wait(60)
    svc.fault_injector = hold
    v = _GRAPHS["t1"].num_vertices
    with TC.ContinuousServer(svc, max_wait_s=0.01, round_chunk=1) as cs:
        busy = [cs.submit("hot", TQ.BfsQuery(s)) for s in (1, 5, 9)]
        busy.append(cs.submit("t0", TQ.BfsQuery(2)))
        assert started.wait(60)          # the wave is running
        late = cs.submit("hot", TQ.BfsQuery(3))
        probe = cs.submit("t1", _probe(kind, v, TQ))
        go.set()
        got = cs.result(probe, timeout=120)
        cs.results(busy + [late], timeout=120)
    assert cs.last_error is None
    _eq(kind, got, _idle_answer(kind))
    _eq("bfs", cs.svc.result(late), _idle_hot_bfs3())
    assert sorted(cs.done_at) == sorted(cs.submit_at)
    assert svc.stats.product_waves == 1
    assert svc.stats.product_cells_padded == 4 * 2 - 5
    assert cs.boarded == 1


def _idle_hot_bfs3():
    idle = JS.GraphService(spec=JSpec(backend="atomic", stats=False))
    idle.register_graph("hot", _GRAPHS["hot"])
    return idle.run("hot", [JQ.BfsQuery(3)])[0]


def test_cache_hit_only_cycle_updates_drain_stats():
    svc = TS.GraphService(spec=TSpec(backend="atomic", stats=False))
    svc.register_graph("g", _port(_GRAPHS["t0"]))
    svc.run("g", [TQ.BfsQuery(0)])
    drains0 = svc.stats.drains
    svc.stats.last_drain_s = 7.5         # stale marker
    cs = TC.ContinuousServer(svc)        # no loop needed for a cache hit
    t = cs.submit("g", TQ.BfsQuery(0))
    assert t in svc._results
    assert svc.stats.drains == drains0 + 1
    assert svc.stats.last_drain_s == 0.0
    h = svc.stats.registry.histogram("aam_submit_to_answer_seconds")
    assert h.count == 1 and h.sum == 0.0


# -- concurrency: threads x faults x WAL ------------------------------------


def test_racing_submitters_with_mid_wave_kill(tmp_path):
    svc = TS.GraphService(spec=TSpec(backend="pallas", stats=False),
                          cache=False)
    for gid, g in _GRAPHS.items():
        svc.register_graph(gid, _port(g))
    sup = ServiceSupervisor(svc, Checkpointer(tmp_path),
                            log=lambda *a: None)
    sup.save()
    kills = {"n": 0}

    def injector(where, i):
        if where == "continuous" and not kills["n"] and i >= 2:
            kills["n"] += 1
            raise RuntimeError(f"injected kill #{kills['n']}")
    svc.fault_injector = injector

    # more submitters than cores, switching threads often
    n_threads, per = (os.cpu_count() or 4) + 2, 2
    tickets: dict[int, tuple] = {}
    tlock = threading.Lock()
    cs = TC.ContinuousServer(sup, max_wait_s=0.01, round_chunk=1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    cs.start()
    try:
        def submitter(tid):
            rng = np.random.default_rng(tid)
            for _ in range(per):
                gid = ["hot", "t0", "t1"][int(rng.integers(3))]
                kind = ["bfs", "sssp", "stconn"][int(rng.integers(3))]
                v = _GRAPHS[gid].num_vertices
                s, t = (int(x) for x in rng.integers(v, size=2))
                q = {"bfs": TQ.BfsQuery(s), "sssp": TQ.SsspQuery(s),
                     "stconn": TQ.StConnQuery(s, t)}[kind]
                tk = cs.submit(gid, q)
                with tlock:
                    tickets[tk] = (gid, q)
                time.sleep(0.002 * float(rng.random()))
        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        rows = {t: cs.result(t, timeout=300) for t in tickets}
    finally:
        cs.stop()
        sys.setswitchinterval(interval)
    assert kills["n"] >= 1, "no kill fired"
    assert sup.restarts == kills["n"]
    assert sorted(rows) == sorted(tickets) == list(range(len(tickets)))
    assert sorted(cs.done_at) == sorted(cs.submit_at)
    seq = JS.GraphService(spec=JSpec(backend="atomic", stats=False),
                          product=False, cache=False)
    for gid, g in _GRAPHS.items():
        seq.register_graph(gid, g)
    order = sorted(tickets)
    jq = {"bfs": lambda q: JQ.BfsQuery(q.source),
          "sssp": lambda q: JQ.SsspQuery(q.source),
          "stconn": lambda q: JQ.StConnQuery(q.s, q.t)}
    for gid in _GRAPHS:
        mine = [t for t in order if tickets[t][0] == gid]
        want = seq.run(gid, [jq[tickets[t][1].kind](tickets[t][1])
                             for t in mine])
        for t, w in zip(mine, want):
            _eq(tickets[t][1].kind, rows[t], w)
