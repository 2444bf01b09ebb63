"""The port's durability layer against the reference package on the CPU:
``repro_torch.checkpoint.checkpointer``, ``repro_torch.runtime.
fault_tolerance`` and ``repro_torch.serve.durable``.

* ``Checkpointer``: both layouts round-trip onto the device asked for,
  async saves with retention, a crash mid-save (the partial step is
  ignored), a restore pinning its step against a concurrent retention
  pass, manifest validation.
* The same on-disk format both ways: a step written by
  ``repro.checkpoint.checkpointer.Checkpointer`` loads in the port's and
  the reverse, single tree and domains, with equal arrays, leaf names,
  treedef strings, versions and meta.
* ``build_snapshot``'s meta equals the reference's after the same
  stream (but for the spec's ``interpret`` and the tuner's entries), its
  domain arrays too; a snapshot written by either package restores in
  the other and answers its queue as the reference's restored service.
* ``Supervisor`` and ``StragglerWatchdog`` against the reference on the
  same inputs; ``ServiceSupervisor``: a crash mid-drain loses no ticket
  and answers none twice, WAL replay skips tickets inside the snapshot,
  a crash mid-save keeps the previous snapshot, the restart budget.
* A restored auto service runs zero timed calibrations (the fits ride
  the snapshot, as in ``tests/test_durability.py``).
"""
import dataclasses
import importlib
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.checkpoint.checkpointer as TCK
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core.commit import CommitSpec as JSpec
from repro.graphs import generators as JG
from repro.runtime import fault_tolerance as JFT
from repro.serve import durable as JD
from repro.serve import graph_service as JS
from repro.serve import queries as JQ
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.convert import to_graph
from repro_torch.core import autotune as AT
from repro_torch.core.commit import CommitSpec as TSpec
from repro_torch.runtime import fault_tolerance as TFT
from repro_torch.serve import durable as TD
from repro_torch.serve import graph_service as TS
from repro_torch.serve import queries as TQ

ADD_RTOL, ADD_ATOL = 2e-4, 1e-6


@pytest.fixture(autouse=True)
def _no_tuner_files(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "off")
    monkeypatch.delenv("REPRO_TRACE", raising=False)


def _silent(*_):
    pass


# -- Checkpointer -----------------------------------------------------------


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(16, 8, generator=g),
            "b": [torch.arange(5, dtype=torch.int32),
                  {"c": torch.tensor(3.5), "d": None}],
            "e": (torch.ones(2, dtype=torch.bool),)}


def _leaves(tree):
    return [x for _, x in TCK._flatten_with_path(tree)]


def test_tree_roundtrip_onto_the_device_asked(tmp_path):
    ck = Checkpointer(tmp_path)
    t = _tree()
    ck.save(10, t)
    got, step = ck.restore(t, device="cpu")
    assert step == 10 and got["b"][1]["d"] is None
    assert isinstance(got["e"], tuple)
    for a, b in zip(_leaves(t), _leaves(got)):
        assert b.device.type == "cpu" and b.dtype == a.dtype
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.restore(t)                                # default: the card


def test_async_save_retention_and_partial_steps(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s), blocking=False)
    ck.wait()
    assert ck.all_steps() == [3, 4]
    bad = tmp_path / "step_00000009"               # crash mid-save
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    assert ck.latest_step() == 4


def test_restore_validates_template_against_manifest(tmp_path):
    ck = Checkpointer(tmp_path)
    t = _tree()
    ck.save(1, t)
    for bad in ({"a": t["a"]}, {"a": t["a"], "z": t["b"], "e": t["e"]}):
        with pytest.raises(ValueError, match="does not match the manifest"):
            ck.restore(bad, device="cpu")
    with pytest.raises(ValueError, match="checkpoint shape"):
        ck.restore(dict(t, a=torch.zeros(3)), device="cpu")


def test_domains_roundtrip_and_validation(tmp_path):
    ck = Checkpointer(tmp_path)
    dom_a = {"x": torch.arange(6), "y": torch.tensor(2.5)}
    dom_b = [torch.ones((3, 2))]
    ck.save_domains(7, {"alpha": dom_a, "beta": dom_b},
                    versions={"alpha": 2}, meta={"note": "hello"})
    assert ck.domains() == {"alpha": 2, "beta": 1}
    assert ck.meta() == {"note": "hello"}
    got, step = ck.restore_domain("alpha", dom_a, device="cpu",
                                  expect_version=2)
    assert step == 7 and torch.equal(got["x"], dom_a["x"])
    arrays, version, _ = ck.load_domain_arrays("beta")
    assert version == 1 and len(arrays) == 1
    np.testing.assert_array_equal(arrays[0], np.ones((3, 2)))
    with pytest.raises(ValueError, match="version"):
        ck.restore_domain("alpha", dom_a, device="cpu", expect_version=9)
    with pytest.raises(KeyError):
        ck.restore_domain("nope", dom_a, device="cpu")
    with pytest.raises(ValueError, match="domain checkpoint"):
        ck.restore(dom_a, device="cpu")
    with pytest.raises(ValueError, match="unsafe"):
        ck.save_domains(8, {"a/b": dom_b})


def test_domain_crash_mid_save_keeps_previous(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save_domains(1, {"d": {"x": torch.arange(4)}}, meta={"gen": 1})
    with pytest.raises(RuntimeError, match="power cut"):
        ck.save_domains(2, {"d": {"x": torch.arange(9)}}, meta={"gen": 2},
                        _pre_commit=lambda: (_ for _ in ()).throw(
                            RuntimeError("power cut")))
    assert ck.latest_step() == 1 and ck.meta() == {"gen": 1}
    arrays, _, _ = ck.load_domain_arrays("d")
    np.testing.assert_array_equal(arrays[0], np.arange(4))
    ck.save_domains(2, {"d": {"x": torch.arange(9)}}, meta={"gen": 2})
    assert ck.latest_step() == 2


def test_retention_skips_step_pinned_by_concurrent_restore(tmp_path,
                                                           monkeypatch):
    ck = Checkpointer(tmp_path, keep=1)
    t = _tree(2)
    ck.save(2, t)
    orig_load = TCK.np.load
    raced = {"done": False}

    def racing_load(path, *a, **kw):
        if not raced["done"]:
            raced["done"] = True
            ck.save(3, _tree(3))          # retention fires mid-restore
        return orig_load(path, *a, **kw)

    monkeypatch.setattr(TCK.np, "load", racing_load)
    got, step = ck.restore(t, step=2, device="cpu")
    assert step == 2 and raced["done"]
    for a, b in zip(_leaves(t), _leaves(got)):
        assert torch.equal(a, b)
    ck.save(4, _tree(4))
    assert ck.all_steps() == [4]


def _np_tree():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "layers": [{"k": np.arange(6, dtype=np.int32)},
                       {"k": np.arange(3, dtype=np.int32), "n": None}],
            "t": (np.float32(1.5), np.ones(2, bool)),
            "odd key!": np.zeros(1, np.int64)}


def _manifest(d, step):
    m = json.loads((d / f"step_{step:08d}" / "manifest.json").read_text())
    m.pop("time")
    return m


def test_same_format_both_ways(tmp_path):
    tree = _np_tree()
    jd, td = tmp_path / "ref", tmp_path / "port"
    jck, tck = JCheckpointer(jd), Checkpointer(td)
    jck.save(3, jax.tree.map(jnp.asarray, tree), extra={"k": 1})
    tck.save(3, tree, extra={"k": 1})
    assert _manifest(td, 3) == _manifest(jd, 3)   # names, treedef, extra
    # the reference's step in the port, the port's in the reference
    got, _ = tck.restore(tree, device="cpu")
    rgot, _ = JCheckpointer(td).restore(jax.eval_shape(
        lambda: jax.tree.map(jnp.asarray, tree)))
    for a, b, c in zip(_leaves(tree), _leaves(got), jax.tree.leaves(rgot)):
        np.testing.assert_array_equal(b.numpy(), a)
        np.testing.assert_array_equal(np.asarray(c), a)
    got2, _ = Checkpointer(jd).restore(tree, device="cpu")
    for a, b in zip(_leaves(tree), _leaves(got2)):
        np.testing.assert_array_equal(b.numpy(), a)
    # the domain layout
    doms = {"graphs": [np.arange(4, dtype=np.int32), np.ones(3, np.float32)],
            "cache": {"x": np.arange(2, dtype=np.int32)}}
    jck.save_domains(5, doms, versions={"graphs": 2}, meta={"m": [1, "a"]})
    tck.save_domains(5, doms, versions={"graphs": 2}, meta={"m": [1, "a"]})
    assert _manifest(td, 5) == _manifest(jd, 5)
    for reader in (Checkpointer(jd), JCheckpointer(td)):
        assert reader.domains() == {"graphs": 2, "cache": 1}
        assert reader.meta() == {"m": [1, "a"]}
        arrays, version, step = reader.load_domain_arrays("graphs")
        assert (version, step) == (2, 5)
        for a, b in zip(arrays, doms["graphs"]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    got3, _ = Checkpointer(jd).restore_domain("cache", doms["cache"],
                                              device="cpu")
    assert torch.equal(got3["x"], torch.arange(2, dtype=torch.int32))


# -- Supervisor and StragglerWatchdog ----------------------------------------


def test_watchdog_matches_reference():
    rng = np.random.default_rng(1)
    jw, tw = JFT.StragglerWatchdog(3.0, 16), TFT.StragglerWatchdog(3.0, 16)
    seen = []
    tw.on_straggler = lambda s, dt: seen.append(s)
    for step in range(200):
        dt = float(rng.exponential(0.1)) * (6 if rng.random() < 0.05 else 1)
        assert tw.observe(step, dt) == jw.observe(step, dt)
    assert dataclasses.asdict(tw.stats) == dataclasses.asdict(jw.stats)
    assert len(seen) == tw.stats.flagged > 0


def test_supervisor_matches_reference(tmp_path):
    for mod, ck in ((JFT, JCheckpointer(tmp_path / "j")),
                    (TFT, Checkpointer(tmp_path / "t"))):
        sup = mod.Supervisor(ck, max_restarts=2)
        with pytest.raises(ValueError, match="nothing"):
            sup.recover_step(ValueError("nothing"), log=_silent)
        ck.save(4, {"x": np.zeros(2)})
        ck.save(6, {"x": np.zeros(2)})
        assert sup.recover_step(RuntimeError("lost"), log=_silent) == 6
        with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
            sup.recover_step(RuntimeError("lost"), log=_silent)
        assert sup.restarts == 3


# -- service snapshots --------------------------------------------------------


def _port(g):
    return to_graph(*(np.asarray(a) for a in
                      (g.indptr, g.src, g.dst, g.weights)),
                    g.num_vertices, device="cpu")


G1 = JG.kronecker(6, 4, seed=1)
G2 = JG.random_weights(JG.erdos_renyi(50, 3.0, seed=2), seed=3)


def _loaded(mod, Q, spec, **kw):
    """A service with warm state in every snapshot domain: two tenants
    (str + int ids), cached array/bool/mst rows, a pending queue."""
    svc = mod.GraphService(spec=spec, max_lanes=4, **kw)
    conv = (lambda g: g) if mod is JS else _port
    svc.register_graph("kron", conv(G1))
    svc.register_graph(7, conv(G2))
    drained = [svc.submit("kron", Q.BfsQuery(0)),
               svc.submit("kron", Q.StConnQuery(0, 9)),
               svc.submit(7, Q.SsspQuery(3)), svc.submit(7, Q.MstQuery()),
               svc.submit(7, Q.PprQuery(4, iters=5))]
    svc.drain()
    pending = [svc.submit("kron", Q.BfsQuery(5)),
               svc.submit(7, Q.SsspQuery(1)),
               svc.submit(7, Q.ColoringQuery(seed=2))]
    return svc, drained, pending


def _pair(**kw):
    return (_loaded(JS, JQ, JSpec(backend="coarse", stats=False), **kw),
            _loaded(TS, TQ, TSpec(backend="coarse", stats=False), **kw))


def _rows_close(a, b, what=""):
    if isinstance(b, bool):
        assert a == b and type(a) is bool, what
    elif isinstance(b, tuple):
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        np.testing.assert_allclose(float(a[1]), float(b[1]), rtol=ADD_RTOL,
                                   atol=ADD_ATOL)
        assert int(a[2]) == int(b[2]), what
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, what
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=what)
        else:
            np.testing.assert_allclose(a, b, rtol=ADD_RTOL, atol=ADD_ATOL,
                                       err_msg=what)


def _comparable(meta):
    """The meta without the spec's ``interpret``, the tuner's entries
    and the MST weights (float sums, compared apart); returns (meta,
    weights)."""
    meta = json.loads(json.dumps(meta))
    meta["config"]["spec"].pop("interpret", None)
    meta.pop("autotune")
    weights = [e["row"].pop("w") for e in meta["cache"] + meta["results"]
               if e["row"]["f"] == "mst"]
    return meta, weights


def test_snapshot_meta_and_domains_match_reference():
    (jsvc, _, _), (tsvc, _, _) = _pair()
    jsnap, tsnap = JD.build_snapshot(jsvc), TD.build_snapshot(tsvc)
    (tmeta, tw), (jmeta, jw) = _comparable(tsnap.meta), \
        _comparable(jsnap.meta)
    assert tmeta == jmeta and len(tw) == len(jw) == 2
    np.testing.assert_allclose(tw, jw, rtol=ADD_RTOL, atol=ADD_ATOL)
    assert tsnap.meta["autotune"] == AT.DEFAULT_TUNER.export_entries()
    assert set(tsnap.domains) == set(jsnap.domains) == set(TD._DOMAINS)
    for d in TD._DOMAINS:
        assert len(tsnap.domains[d]) == len(jsnap.domains[d])
        for a, b in zip(tsnap.domains[d], jsnap.domains[d]):
            _rows_close(a, b, d)
    assert TD.SNAPSHOT_VERSION == JD.SNAPSHOT_VERSION


@pytest.mark.parametrize("writer", ("reference", "port"))
def test_snapshot_restores_across_packages(tmp_path, writer):
    """A snapshot written by either package restores in both; the two
    restored services answer the pending queue alike."""
    (jsvc, jdone, pending), (tsvc, _, _) = _pair()
    if writer == "reference":
        JD.save_snapshot(JCheckpointer(tmp_path), jsvc.snapshot())
    else:
        TD.save_snapshot(Checkpointer(tmp_path), tsvc.snapshot())
    jsnap, _ = JD.load_snapshot(JCheckpointer(tmp_path))
    tsnap, step = TD.load_snapshot(Checkpointer(tmp_path))
    assert step == 1
    jr = JD.restore_service(jsnap)
    tr = TD.restore_service(tsnap, device="cpu")
    assert tr._next_ticket == jr._next_ticket and tr.pending() == 3
    assert set(tr._graphs) == {"kron", 7}
    assert all(g.device.type == "cpu" for g in tr._graphs.values())
    for t in jdone:
        _rows_close(tr.result(t), jr.result(t), t)
    jd, td = jr.drain(), tr.drain()
    assert sorted(td) == sorted(jd) == pending
    for t in pending:
        _rows_close(tr.result(t), jr.result(t), t)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.restore_service(tsnap)                     # default: the card


def test_snapshot_guards(tmp_path):
    svc = TS.GraphService()
    svc.register_graph(("tuple", "id"), _port(G1))
    with pytest.raises(TypeError, match="str or int"):
        TD.build_snapshot(svc)
    for q in (TQ.BfsQuery(3), TQ.StConnQuery(2, 5), TQ.MstQuery(),
              TQ.PprQuery(1, iters=4), TQ.ColoringQuery(seed=3)):
        d = TQ.query_to_dict(q)
        assert TQ.query_from_dict(d) == q
        assert d == JQ.query_to_dict(getattr(JQ, type(q).__name__)(
            **dataclasses.asdict(q)))
    ck = Checkpointer(tmp_path)
    ck.save_domains(1, {"d": {"x": np.arange(3)}}, meta={"schema": "?"})
    with pytest.raises(ValueError, match="not a service snapshot"):
        TD.load_snapshot(ck)
    for site in TD.REPLAY_GUARDS:
        obj = importlib.import_module(site.module)
        for part in site.qualname.split("."):
            obj = getattr(obj, part)
        assert site.witness in inspect.getsource(obj), site.name


def test_learned_m_and_clock_ride_the_snapshot():
    clk = lambda: 5.0                                     # noqa: E731
    svc = TS.GraphService(clock=clk)               # default auto spec
    assert svc._spec_for("bfs", "g") is svc.spec

    class Res:
        m_final = 256

    svc._learn_m("bfs", "g", Res)
    Res.m_final = -1
    svc._learn_m("sssp", "g", Res)
    assert svc._m_learned == {("bfs", "g"): 256}
    assert svc._spec_for("bfs", "g").seed_m == 256
    svc.register_graph("g", _port(G1))
    svc2 = TS.GraphService.restore(svc.snapshot(), clock=clk, device="cpu")
    assert svc2._m_learned == {("bfs", "g"): 256} and svc2.clock is clk
    pinned = TS.GraphService(spec=TSpec(backend="auto", m=32))
    pinned._m_learned[("bfs", "g")] = 256
    assert pinned._spec_for("bfs", "g").m == 32
    assert TS.GraphService.restore(
        TS.GraphService(product=False).snapshot(),
        device="cpu").product is False


def test_restored_auto_service_runs_zero_timed_calibrations(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE")
    t1 = AT.AutoTuner(ns=(4, 16), v_cal=256, repeats=1, warmup=0)
    monkeypatch.setattr(AT, "DEFAULT_TUNER", t1)
    svc = TS.GraphService(max_lanes=2, cache=False)      # default auto spec
    svc.register_graph("g", _port(G1))
    svc.register_graph("h", _port(G2))
    qs = [TQ.BfsQuery(2), TQ.BfsQuery(9)]
    ref = svc.run("g", qs)
    svc.submit("g", TQ.SsspQuery(1))
    svc.submit("h", TQ.BfsQuery(0))
    svc.drain()
    assert t1.timed_runs > 0 and svc.stats.timing_runs == t1.timed_runs
    snap = svc.snapshot()
    assert snap.meta["autotune"]
    t2 = AT.AutoTuner(ns=(4, 16), v_cal=256, repeats=1, warmup=0)
    monkeypatch.setattr(AT, "DEFAULT_TUNER", t2)
    monkeypatch.setattr(t2, "_time", lambda *a: pytest.fail(
        "restored service ran a timed micro-benchmark"))
    svc2 = TS.GraphService.restore(snap, device="cpu")
    got = svc2.run("g", qs)
    svc2.submit("g", TQ.SsspQuery(1))
    svc2.submit("h", TQ.BfsQuery(0))
    svc2.drain()
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    assert svc2.stats.timing_runs == 0 and t2.timed_runs == 0


# -- ServiceSupervisor --------------------------------------------------------


def _bfs_ref(g, s):
    from repro.graphs.algorithms.bfs import bfs
    return np.asarray(bfs(g, s).dist)


def test_supervisor_crash_mid_drain_loses_no_ticket(tmp_path):
    svc = TS.GraphService(spec=TSpec(backend="pallas", stats=False),
                          max_lanes=2, cache=False)
    svc.register_graph("g", _port(G1))
    sup = TD.ServiceSupervisor(svc, Checkpointer(tmp_path), log=_silent)
    pre = [sup.submit("g", TQ.BfsQuery(s)) for s in (0, 1)]
    sup.drain()
    sup.save()
    post = [sup.submit("g", TQ.BfsQuery(s)) for s in (2, 3, 4, 5)]
    crashes = {"n": 0}

    def injector(where, i):      # the second wave of this drain
        if i == 2:
            crashes["n"] += 1
            raise RuntimeError("host lost")
    svc.fault_injector = injector
    done = sup.drain()
    assert crashes["n"] == 1 and sup.restarts == 1
    assert sup.service is not svc and sorted(done) == post
    for t, s in zip(pre + post, (0, 1, 2, 3, 4, 5)):
        np.testing.assert_array_equal(sup.result(t).numpy(), _bfs_ref(G1, s))
    assert sup.service.pending() == 0
    assert sup.service._next_ticket == len(pre) + len(post)
    assert sup.service._graphs["g"].device.type == "cpu"


def test_supervisor_replay_skips_tickets_inside_snapshot(tmp_path):
    svc = TS.GraphService(spec=TSpec(backend="coarse", stats=False),
                          cache=False)
    svc.register_graph("g", _port(G1))
    sup = TD.ServiceSupervisor(svc, Checkpointer(tmp_path), log=_silent)
    t0 = sup.submit("g", TQ.BfsQuery(0))
    sup.drain()
    TD.save_snapshot(sup.ckpt, svc.snapshot())   # no WAL truncation
    assert sup._wal.read_text().strip()
    restored = sup.restore()
    assert restored.pending() == 0
    np.testing.assert_array_equal(restored.result(t0).numpy(),
                                  _bfs_ref(G1, 0))


def test_supervisor_crash_mid_save_and_restart_budget(tmp_path):
    svc = TS.GraphService(spec=TSpec(backend="atomic", stats=False),
                          cache=False)
    svc.register_graph("g", _port(G1))
    sup = TD.ServiceSupervisor(svc, Checkpointer(tmp_path), max_restarts=1,
                               log=_silent)
    t = sup.submit("g", TQ.BfsQuery(1))
    sup.drain()
    sup.save()
    sup.submit("g", TQ.BfsQuery(2))
    with pytest.raises(RuntimeError, match="disk gone"):
        sup.save(_pre_commit=lambda: (_ for _ in ()).throw(
            RuntimeError("disk gone")))
    restored = sup.restore()                     # the previous snapshot
    restored.result(t)
    assert restored.pending() == 1               # BfsQuery(2) via the WAL

    def always_crash(where, i):
        raise RuntimeError("flaky host")
    restored.fault_injector = always_crash
    sup.drain()          # crash 1: the restored instance finishes
    assert sup.restarts == 1
    sup.service.fault_injector = always_crash
    sup.submit("g", TQ.BfsQuery(3))
    with pytest.raises(RuntimeError, match="restarts"):
        sup.drain()      # crash 2: budget exhausted
