"""The port's observability (``repro_torch.obs``) against the reference
package on the CPU.

* ``Tracer`` under a fake clock: the same span, instant and complete
  sequence gives the same ``to_chrome()`` document; ``validate_trace``
  and ``validate_metrics_json`` give the same findings.
* ``Registry``: histogram quantiles, ``prometheus_text`` and snapshots
  equal.
* ``wavetap``: under ``REPRO_TRACE=1`` the records of ``bfs`` and
  ``pagerank`` on ``backend="auto"`` and of ``distributed_bfs`` at world
  size 1 (the reference on a one-device mesh) equal the reference's in
  every key but ``"t"``; ``summary`` and ``flush_to`` equal on the same
  records; with tracing off nothing is recorded.
"""
import json
import math

import numpy as np
import pytest

import repro.obs.metrics as JM
import repro.obs.trace as JT
import repro.obs.wavetap as JW
from repro.core.commit import CommitSpec as JSpec
from repro.graphs import generators as JG
from repro.graphs.algorithms import bfs as JB
from repro.graphs.algorithms import pagerank as JP
from repro.launch.mesh import make_host_mesh
from repro_torch import obs as TO
from repro_torch.convert import to_graph
from repro_torch.core.commit import CommitSpec as TSpec
from repro_torch.graphs.algorithms import bfs as TB
from repro_torch.graphs.algorithms import pagerank as TP
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import metrics as TM
from repro_torch.obs import trace as TT
from repro_torch.obs import wavetap as TW


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "off")
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    JW.clear()
    TW.clear()
    yield
    JW.clear()
    TW.clear()


def _script(mod):
    """One span sequence on ``mod``'s Tracer under a fake clock."""
    clk = FakeClock(10.0)
    tr = mod.Tracer(clock=clk, enabled=True)
    with tr.span("outer", args={"a": 1}):
        clk.tick(1.0)
        with tr.span("inner", cat="engine", tid=mod.TID_DEVICE):
            clk.tick(0.5)
        tr.instant("mark", args={"k": "v"})
        clk.tick(0.25)
    tr.begin("manual")
    clk.tick(2.0)
    tr.end(args={"late": True})
    tr.complete("done", 3.0, 0.125, cat="wave", args={"n": 3})
    with pytest.raises(RuntimeError):
        with tr.span("faulty"):
            clk.tick(0.01)
            raise RuntimeError("boom")
    tr.end()                                  # nothing open: a no-op
    return tr


def test_tracer_export_matches_reference():
    jt, tt = _script(JT), _script(TT)
    assert tt.to_chrome() == jt.to_chrome()
    assert tt.open_spans() == jt.open_spans() == []
    assert TT.validate_trace(tt.to_chrome()) == []
    assert TT.TRACE_SCHEMA == JT.TRACE_SCHEMA == "aam-trace/v1"


@pytest.mark.parametrize("doc", [
    None, {}, {"traceEvents": 3},
    {"traceEvents": [{"name": "x", "ph": "X", "ts": 0, "pid": 1, "tid": 0}]},
    {"traceEvents": [{"name": "x", "ph": "i", "ts": 0, "pid": 1, "tid": 0,
                      "s": "q"}]},
    {"traceEvents": [{"name": "x", "ph": "Q", "ts": "a", "pid": 1,
                      "tid": 0}]},
    {"traceEvents": [{"ph": "B"}]}])
def test_validate_trace_matches_reference(doc):
    assert TT.validate_trace(doc) == JT.validate_trace(doc)


def test_inactive_tracer_follows_env(monkeypatch):
    reads = []
    tr = TT.Tracer(clock=lambda: reads.append(1) or 0.0)
    with tr.span("s"):
        pass
    tr.instant("i")
    assert reads == [] and tr.events == []
    monkeypatch.setenv("REPRO_TRACE", "1")
    assert tr.active and TT.trace_enabled()
    TT.set_tracer(None)
    assert isinstance(TT.get_tracer(), TT.Tracer)
    mine = TT.Tracer(enabled=True)
    TT.set_tracer(mine)
    assert TT.get_tracer() is mine
    TT.set_tracer(None)


def _registry(mod):
    reg = mod.Registry()
    reg.counter("aam_c", help="a counter").inc(2)
    reg.gauge("aam_g").set(1.5)
    h = reg.histogram("aam_h", help="latency")
    for v in np.random.default_rng(0).exponential(0.01, 300):
        h.observe(v)
    h.observe(1e9)
    reg.histogram("aam_small", bounds=(0.5, 1.0, 2.0)).observe(0.75)
    return reg


def test_metrics_match_reference():
    jr, tr = _registry(JM), _registry(TM)
    assert tr.prometheus_text() == jr.prometheus_text()
    assert tr.snapshot() == jr.snapshot()
    jh, th = jr.histogram("aam_h"), tr.histogram("aam_h")
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    for v in (0.0, 1e-7, 0.003, 100.0):
        assert th.bucket_of(v) == jh.bucket_of(v)
    assert math.isnan(TM.Histogram("e").quantile(0.5))
    snap = tr.snapshot()
    bad = json.loads(json.dumps(snap).replace('"count": 1,', '"count": 9,'))
    for doc in (snap, {"schema": "nope"}, bad, [], {"schema": TM.METRICS_SCHEMA,
                                                   "counters": {"x": "y"}}):
        assert TM.validate_metrics_json(doc) == JM.validate_metrics_json(doc)
    with pytest.raises(TypeError):
        tr.gauge("aam_c")
    assert TO.Registry is TM.Registry and TO.wavetap is TW


def _port(g):
    return to_graph(*[np.asarray(a) for a in (g.indptr, g.src, g.dst,
                                             g.weights)],
                    g.num_vertices, device="cpu")


def _strip(recs):
    return [{k: v for k, v in r.items() if k != "t"} for r in recs]


@pytest.mark.parametrize("alg", ["bfs", "pagerank"])
def test_commit_tap_records_match_reference(alg, monkeypatch):
    monkeypatch.setenv("REPRO_TRACE", "1")
    g = JG.kronecker(6, 8, seed=7)
    tg = _port(g)
    src = int(np.argmax(np.asarray(g.degrees)))
    # a tile_m no other test uses, so the reference traces its jitted loop
    # afresh with the tap in it
    kw = dict(backend="auto", stats=False, tile_m=96)
    if alg == "bfs":
        JB.bfs(g, src, spec=JSpec(**kw)).dist.block_until_ready()
        TB.bfs(tg, src, spec=TSpec(**kw))
    else:
        JP.pagerank(g, iters=6, spec=JSpec(**kw))[0].block_until_ready()
        TP.pagerank(tg, iters=6, spec=TSpec(**kw))
    exp, got = JW.records(), TW.records()
    assert exp and _strip(got) == _strip(exp)
    assert TW.summary(got) == JW.summary(exp)


def test_round_tap_records_match_reference(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE", "1")
    g = JG.kronecker(6, 8, seed=7)
    src = int(np.argmax(np.asarray(g.degrees)))
    kw = dict(backend="auto", stats=False)
    JB.distributed_bfs(make_host_mesh(1, 1), g, src, capacity=64,
                       spec=JSpec(**kw), max_subrounds=256)
    TB.distributed_bfs(make_mesh(device="cpu"), _port(g), src, capacity=64,
                       spec=TSpec(**kw), max_subrounds=256)
    exp, got = JW.records(), TW.records()
    assert [r["kind"] for r in got] == ["round"] * len(got)
    assert exp and _strip(got) == _strip(exp)
    assert TW.summary(got) == JW.summary(exp)


def test_tracing_off_records_nothing():
    g = JG.kronecker(6, 8, seed=7)
    tg = _port(g)
    TB.bfs(tg, 0, spec=TSpec(backend="auto", stats=False))
    TB.distributed_bfs(make_mesh(device="cpu"), tg, 0, capacity=64,
                       spec=TSpec(backend="pallas"), max_subrounds=256)
    TP.pagerank(tg, iters=2, spec=TSpec(backend="coarse"))
    assert TW.records() == []


def test_spec_trace_taps_without_the_env():
    g = JG.kronecker(6, 8, seed=7)
    r = TB.bfs(_port(g), 0, spec=TSpec(backend="pallas", trace=True))
    recs = TW.records()
    assert len(recs) == r.rounds
    assert {(x["kind"], x["label"], x["op"], x["backend"]) for x in recs} \
        == {("commit", "min", "min", "pallas")}
    assert sum(x["messages"] for x in recs) == int(r.messages)


def test_summary_and_flush_match_reference():
    recs = [
        {"kind": "round", "label": "x", "t": 1.0, "round": 0,
         "conflicts": 2, "subrounds": 1, "messages": 10, "level": 0,
         "shard": 0},
        {"kind": "commit", "label": "min", "op": "min", "backend": "coarse",
         "t": 1.25, "conflicts": 3, "applied": 4, "messages": 7,
         "level": 2},
        {"kind": "round", "label": "x", "t": 1.5, "round": 1,
         "conflicts": 0, "subrounds": 2, "messages": 4, "level": 1,
         "shard": 0},
        {"kind": "round", "label": "x", "t": 1.75, "round": 1,
         "conflicts": 0, "subrounds": 2, "messages": 0, "level": 1,
         "shard": 1},
        {"kind": "commit", "label": "min", "op": "min", "backend": "coarse",
         "t": 2.5, "conflicts": 0, "applied": 0, "messages": 0,
         "level": 3}]
    assert TW.summary(recs) == JW.summary(recs)
    docs = []
    for tracer_mod, tap in ((JT, JW), (TT, TW)):
        for r in recs:
            tap.collector().add(dict(r))
        tr = tracer_mod.Tracer(clock=FakeClock(), enabled=True)
        assert tap.flush_to(tr) == len(recs) and tap.records() == []
        docs.append(tr.to_chrome())
    assert docs[1] == docs[0]
    assert TT.validate_trace(docs[1]) == []
    for r in recs:
        TW.collector().add(dict(r))
    assert TW.flush_to(TT.Tracer(enabled=False)) == len(recs)
    assert TW.records() == []


def test_new_modules_import_nothing_of_the_reference():
    """``repro_torch.obs`` loads no kernel code, and none of the new
    modules pulls in JAX or the reference package."""
    import os
    import pathlib
    import subprocess
    import sys
    code = ("import sys, repro_torch.obs; "
            "kernels = [m for m in sys.modules if 'kernels' in m]; "
            "import repro_torch.core.autotune, repro_torch.core.ownership, "
            "repro_torch.analysis.sanitize; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(kernels, bad)")
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.stdout.strip() == "[] []"


# -- the serving layer's spans, instants and metrics --------------------------


class CountingClock(FakeClock):
    def __init__(self, t=0.0):
        super().__init__(t)
        self.reads = 0

    def __call__(self):
        self.reads += 1
        return self.t


def test_service_stats_is_registry_view():
    from repro.serve.graph_service import ServiceStats as JStats
    from repro_torch.serve.graph_service import ServiceStats as TStats
    texts = []
    for cls in (JStats, TStats):
        st = cls()
        st.waves += 3
        st.graph_waves += 2
        st.product_waves += 1
        st.last_drain_s = 0.5
        assert st.total_waves == 6
        assert st.registry.counter("aam_waves").value == 3
        assert st.registry.gauge("aam_last_drain_s").value == 0.5
        assert "waves=3" in repr(st)
        with pytest.raises(AttributeError):
            st.nonexistent_field
        texts.append((st.registry.prometheus_text(), repr(st),
                      st.registry.snapshot()))
    assert texts[1] == texts[0]


def _served_trace(gs_mod, q_mod, spec, graph):
    """One traced script on a service under a fake clock: a submit, a
    drain, a cache hit."""
    clk = CountingClock()
    tr = (JT if gs_mod.__name__.startswith("repro.") else TT).Tracer(
        clock=clk, enabled=True)
    svc = gs_mod.GraphService(clock=clk, tracer=tr, spec=spec)
    svc.register_graph("g", graph)
    svc.submit("g", q_mod.BfsQuery(0))
    r0 = clk.reads
    svc.drain()
    reads = clk.reads - r0
    svc.submit("g", q_mod.BfsQuery(0))        # cache hit
    return tr, reads


def test_serving_trace_matches_reference():
    """The drain span reuses the drain's two clock reads (4 with the one
    wave's span), submit instants record cache hits, and the whole
    document equals the reference's on the same script."""
    from repro.serve import graph_service as JS
    from repro.serve import queries as JQ
    from repro_torch.serve import graph_service as TS
    from repro_torch.serve import queries as TQ
    g = JG.erdos_renyi(20, 3.0, seed=0)
    jt, jreads = _served_trace(JS, JQ, JSpec(backend="atomic", stats=False),
                               g)
    tt, treads = _served_trace(TS, TQ, TSpec(backend="atomic", stats=False),
                               _port(g))
    assert treads == jreads == 4
    subs = [e for e in tt.events if e["name"] == "submit"]
    assert [s["args"]["cache_hit"] for s in subs] == [False, True]
    drain = next(e for e in tt.events if e["name"] == "drain")
    assert drain["args"]["done"] == 1
    assert tt.open_spans() == []
    assert tt.to_chrome() == jt.to_chrome()


def test_crash_restore_redrain_single_trace(tmp_path):
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.serve.durable import ServiceSupervisor
    from repro_torch.serve.graph_service import GraphService
    from repro_torch.serve.queries import BfsQuery
    clk = FakeClock()
    tr = TT.Tracer(clock=clk, enabled=True)
    svc = GraphService(clock=clk, tracer=tr, cache=False,
                       spec=TSpec(backend="pallas", stats=False))
    g = JG.erdos_renyi(24, 3.0, seed=5)
    svc.register_graph("g", _port(g))
    sup = ServiceSupervisor(svc, Checkpointer(tmp_path),
                            log=lambda *_: None)
    sup.save()
    tickets = [sup.submit("g", BfsQuery(s)) for s in range(3)]
    kill = svc._wave_i
    svc.fault_injector = (
        lambda where, i: (_ for _ in ()).throw(
            RuntimeError("host lost")) if i == kill else None)
    done = sup.drain()                  # crash -> restore -> re-drain
    assert sorted(done) == tickets
    assert sup.service.tracer is tr and tr.open_spans() == []
    names = [e["name"] for e in tr.events]
    assert names.count("drain") == 2
    inst = [e["name"] for e in tr.events if e["ph"] == "i"]
    assert "restore" in inst and "wal_replay" in inst
    wal = next(e for e in tr.events if e["name"] == "wal_replay")
    assert wal["args"]["replayed"] == 3
    assert TT.validate_trace(tr.to_chrome()) == []
    for s, t in zip(range(3), tickets):
        np.testing.assert_array_equal(sup.result(t).numpy(),
                                      np.asarray(JB.bfs(g, s).dist))


def test_continuous_latency_histogram():
    from repro_torch.serve.continuous import ContinuousServer
    from repro_torch.serve.graph_service import GraphService
    from repro_torch.serve.queries import BfsQuery
    svc = GraphService(cache=False,
                       spec=TSpec(backend="atomic", stats=False))
    svc.register_graph("g", _port(JG.kronecker(5, 6, seed=1)))
    svc.register_graph("h", _port(JG.erdos_renyi(30, 4.0, seed=2)))
    with ContinuousServer(svc, max_wait_s=0.005) as cs:
        tickets = [cs.submit("g", BfsQuery(s)) for s in range(4)]
        tickets += [cs.submit("h", BfsQuery(s)) for s in range(3)]
        cs.results(tickets, timeout=120)
    assert cs.last_error is None
    lat = [cs.done_at[t] - cs.submit_at[t] for t in tickets]
    h = cs.svc.stats.registry.histogram("aam_submit_to_answer_seconds")
    assert h.count == len(tickets)
    assert h.sum == pytest.approx(sum(lat))
    for q in (0.5, 0.99):
        exact = float(np.percentile(lat, q * 100))
        assert abs(h.bucket_of(exact) - h.bucket_of(h.quantile(q))) <= 1


def test_dump_writes_a_valid_trace_and_metrics(tmp_path):
    import os
    import pathlib
    import subprocess
    import sys
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src), "REPRO_AUTOTUNE": "off",
           "REPRO_AUTOTUNE_CACHE": "off"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.dump", "--device", "cpu",
         "--scale", "5", "--out", "T.json", "--metrics", "M"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    doc = json.loads((tmp_path / "T.json").read_text())
    assert TT.validate_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"drain", "product_wave", "submit"} <= names
    snap = json.loads((tmp_path / "M.json").read_text())
    assert TM.validate_metrics_json(snap) == []
    assert snap["histograms"]["aam_submit_to_answer_seconds"]["count"] == 11
    assert "aam_product_waves" in (tmp_path / "M.prom").read_text()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "M.json", "M.prom", "T.json"]
