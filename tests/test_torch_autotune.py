"""The port's tuner (``repro_torch.core.autotune``, ``core.perf_model``)
against the reference package on the CPU.

* ``perf_model``: fits, crossing points and M* equal on the same inputs.
* Policies: with ``REPRO_AUTOTUNE=off`` equal field for field over n x
  ``m`` x ``seed_m``; with both tuners' ``calibrate``/``race`` replaced by
  the same fits and the same race verdict, ``_policy`` equal over n x op
  (and the same races asked for).
* ``next_level`` equal over a density grid (float32 density at the
  waterlines); ``ladder_commit`` at every level equal to the reference's
  commit over the five ops (bit for bit; float ``add`` within rtol 2e-4 /
  atol 1e-6); ``make_commit_step``'s level trajectory equal.
* ``backend="auto"`` on the six algorithms equal to the reference's auto
  run, and every entry point (lane, graph-set and engine forms too) under
  ``CommitSpec(backend="auto", trace=True)`` equal to its static run.
* The persistent cache round-trips, a corrupt file is ignored, and the
  kernel tiers stay out of the candidates on the CPU with an audit event.

Every test runs with ``REPRO_AUTOTUNE_CACHE`` off or in ``tmp_path``, and
calibrations at ``ns <= (4, 16)``, ``v_cal <= 256``.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as JAT
from repro.core import perf_model as JPM
from repro.core.commit import CommitSpec as JSpec
from repro.core.messages import make_messages as jmake
from repro.graphs import generators as JG
from repro.graphs.algorithms import bfs as JB
from repro.graphs.algorithms import boruvka as JBo
from repro.graphs.algorithms import coloring as JC
from repro.graphs.algorithms import pagerank as JP
from repro.graphs.algorithms import sssp as JS
from repro.graphs.algorithms import stconn as JST
from repro_torch.convert import to_graph, to_graphset
from repro_torch.core import autotune as TAT
from repro_torch.core import perf_model as TPM
from repro_torch.core.commit import CommitSpec as TSpec
from repro_torch.core.messages import make_messages as tmake
from repro_torch.graphs.algorithms import bfs as TB
from repro_torch.graphs.algorithms import boruvka as TBo
from repro_torch.graphs.algorithms import coloring as TC
from repro_torch.graphs.algorithms import pagerank as TP
from repro_torch.graphs.algorithms import sssp as TS
from repro_torch.graphs.algorithms import stconn as TST
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import wavetap

ADD_RTOL, ADD_ATOL = 2e-4, 1e-6
OPS = ("min", "max", "add", "or", "first")
POLICY_FIELDS = ("backend", "ladder", "init_level", "adaptive", "high_water",
                 "low_water", "sort", "stats", "tile_m", "block_v",
                 "sanitize")
SMALL = dict(ns=(4, 16), v_cal=256, warmup=0, repeats=1)


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
def _no_cache_file(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "off")


def _fields(pol):
    return tuple(getattr(pol, f) for f in POLICY_FIELDS)


# -- perf_model --------------------------------------------------------------

FITS = [((8, 64, 512), (1.0, 2.0, 9.0)),
        ((4, 16), (3e-5, 3.1e-5)),
        ((8, 64, 512), (5e-5, 4e-5, 4.5e-5)),
        ((1, 2, 3, 4), (2.0, 4.0, 6.0, 8.0))]


@pytest.mark.parametrize("ns,ts", FITS)
def test_perf_model_matches_reference(ns, ts):
    jf, tf = JPM.fit(ns, ts), TPM.fit(ns, ts)
    assert (tf.intercept, tf.slope, tf.r2) == (jf.intercept, jf.slope,
                                               jf.r2)
    np.testing.assert_array_equal(tf.predict([1, 10, 1000]),
                                  jf.predict([1, 10, 1000]))
    for fine_slope in (1e-6, 1e-4, 1.0):
        for cap in (4096, 3000, 16):
            jfine = JPM.LinearFit(0.0, fine_slope, 1.0)
            tfine = TPM.LinearFit(0.0, fine_slope, 1.0)
            assert TPM.crossing_point(tfine, tf) == \
                JPM.crossing_point(jfine, jf)
            assert TPM.select_m(tfine, tf, cap=cap) == \
                JPM.select_m(jfine, jf, cap=cap)


# -- policies ------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 100, 1000, 5000, 70000])
@pytest.mark.parametrize("m", [None, 64])
@pytest.mark.parametrize("seed_m", [None, 0, 256])
def test_policy_autotune_off_matches_reference(n, m, seed_m, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    kw = dict(backend="auto", m=m, seed_m=seed_m, stats=False, tile_m=128)
    jpol = JAT.policy_for(JSpec(**kw), jnp.zeros((300,), jnp.int32), n=n,
                          op="min", tuner=JAT.AutoTuner())
    tpol = TAT.policy_for(TSpec(**kw), torch.zeros(300, dtype=torch.int32),
                          n=n, op="min", tuner=TAT.AutoTuner())
    assert _fields(tpol) == _fields(jpol)


def _fake_tuner(mod, fits, races):
    """A tuner whose calibration returns ``fits`` and whose race picks
    the alphabetically last finalist, recording what it was asked."""
    tuner = mod.AutoTuner(**SMALL)

    def calibrate(*, with_pallas, **kw):
        tiers = tuple((b, mod.perf_model.LinearFit(*f))
                      for b, f in fits["tiers"]
                      if with_pallas or b not in ("pallas", "fused"))
        return mod.Calibration(
            fine=mod.perf_model.LinearFit(0.0, fits["fine"], 1.0),
            tiers=tiers)

    def race(finalists, n, **kw):
        races.append((dict(finalists), n, kw["v"], kw["axis_width"]))
        return sorted(finalists)[-1]

    tuner.calibrate, tuner.race = calibrate, race
    return tuner


FAKE_FITS = [
    {"fine": 1e-6, "tiers": (("atomic", (2e-5, 1e-8, 1.0)),
                             ("coarse", (9e-5, 1e-9, 1.0)),
                             ("pallas", (3e-5, 2e-9, 1.0)),
                             ("fused", (3.1e-5, 2e-9, 1.0)))},
    {"fine": 2e-5, "tiers": (("atomic", (1e-5, 0.0, 0.5)),
                             ("coarse", (5e-5, 0.0, 0.9)),
                             ("pallas", (4e-4, 0.0, 0.9)),
                             ("fused", (4e-4, 1e-7, 0.9)))},
]


@pytest.mark.parametrize("fits", range(len(FAKE_FITS)))
@pytest.mark.parametrize("op", OPS)
def test_policy_with_same_fits_matches_reference(fits, op, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    for n in (1, 3, 50, 2048, 40000):
        for pallas_ok in (False, True):
            for kw in (dict(), dict(seed_m=0), dict(seed_m=64), dict(m=16),
                       dict(stats=True)):
                jr, tr = [], []
                jt = _fake_tuner(JAT, FAKE_FITS[fits], jr)
                tt = _fake_tuner(TAT, FAKE_FITS[fits], tr)
                spec = dict(backend="auto", **kw)
                jpol = jt._policy(JSpec(**spec), n=n, pallas_ok=pallas_ok,
                                  v=512, op=op, axis_width=4)
                tpol = tt._policy(TSpec(**spec), n=n, pallas_ok=pallas_ok,
                                  v=512, op=op, axis_width=4, device="cpu")
                assert _fields(tpol) == _fields(jpol), (n, pallas_ok, kw)
                assert tr == jr


def test_next_level_matches_reference():
    for level in range(6):
        for adaptive in (True, False):
            jpol = JAT.TunerPolicy(backend="coarse", adaptive=adaptive)
            tpol = TAT.TunerPolicy(backend="coarse", adaptive=adaptive)
            for messages in (0, 1, 3, 20, 100, 1000, 77777):
                for conflicts in sorted({0, 1, 2, messages // 20,
                                         messages // 20 + 1,
                                         (3 * messages) // 10,
                                         (3 * messages) // 10 + 1,
                                         messages // 2, messages}):
                    exp = int(JAT.next_level(
                        jpol, jnp.asarray(level, jnp.int32),
                        jnp.asarray(conflicts, jnp.int32),
                        jnp.asarray(messages, jnp.int32)))
                    got = TAT.next_level(
                        tpol, level,
                        torch.tensor(conflicts, dtype=torch.int32),
                        torch.tensor(messages))
                    assert got == exp, (level, adaptive, conflicts,
                                        messages)


def _state_and_batch(op, dtype, v, n, seed):
    rng = np.random.default_rng(seed)
    if op == "min":
        state = np.full(v, 1000, dtype)
    elif op == "max":
        state = np.full(v, -1000, dtype)
    elif op == "first":
        state = np.where(rng.random(v) < 0.5, -1, 777).astype(dtype)
    else:
        state = np.zeros(v, dtype)
    lo, hi = (0, 2) if op == "or" else ((0, 50) if op == "first"
                                        else (-50, 50))
    tgt = rng.integers(0, v, n).astype(np.int32)
    val = rng.integers(lo, hi, n).astype(dtype)
    if dtype == np.float32 and op == "add":
        val = rng.standard_normal(n).astype(np.float32)
    valid = rng.random(n) < 0.8
    return state, tgt, val, valid


def _assert_result(tres, jres, op, dtype):
    if op == "add" and dtype == np.float32:
        np.testing.assert_allclose(tres.state.numpy(),
                                   np.asarray(jres.state),
                                   rtol=ADD_RTOL, atol=ADD_ATOL)
    else:
        np.testing.assert_array_equal(tres.state.numpy(),
                                      np.asarray(jres.state))
    np.testing.assert_array_equal(tres.success.numpy(),
                                  np.asarray(jres.success))
    assert (int(tres.conflicts), int(tres.applied)) == \
        (int(jres.conflicts), int(jres.applied))


@pytest.mark.parametrize("backend", ["coarse", "pallas"])
@pytest.mark.parametrize("op,dtype", [(op, np.int32) for op in OPS]
                         + [("add", np.float32)])
def test_ladder_commit_matches_reference(backend, op, dtype):
    state, tgt, val, valid = _state_and_batch(op, dtype, 61, 120, 11)
    jm = jmake(jnp.asarray(tgt), jnp.asarray(val), jnp.asarray(valid))
    tm = tmake(torch.from_numpy(tgt), torch.from_numpy(val),
               torch.from_numpy(valid))
    kw = dict(backend=backend, stats=True, tile_m=32)
    jpol, tpol = JAT.TunerPolicy(**kw), TAT.TunerPolicy(**kw)
    jladder = jax.jit(lambda s, m, lvl: JAT.ladder_commit(s, m, op, jpol,
                                                          lvl))
    for level in range(len(JAT.M_LADDER)):
        jres = jladder(jnp.asarray(state), jm,
                       jnp.asarray(level, jnp.int32))
        tres = TAT.ladder_commit(torch.from_numpy(state.copy()), tm, op,
                                 tpol, level)
        _assert_result(tres, jres, op, dtype)


def test_make_commit_step_level_trajectory_matches_reference(monkeypatch):
    """Commits whose conflict density swings between a storm (every
    message on two vertices) and quiet rounds (distinct targets): the
    state and the level each step returns are the reference's."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    rng = np.random.default_rng(5)
    v = n = 64
    state = np.full(v, 1000, np.int32)
    jstep, jl = JAT.make_commit_step(JSpec(backend="auto", stats=False),
                                     "min", jnp.asarray(state), n=n)
    tstep, tl = TAT.make_commit_step(TSpec(backend="auto", stats=False),
                                     "min", torch.from_numpy(state), n=n)
    assert tl == int(jl)
    jstep = jax.jit(jstep)        # as the reference's loops run it
    levels = [tl]
    for storm in (1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 0):
        tgt = (rng.integers(0, 2, n) if storm
               else rng.permutation(v)).astype(np.int32)
        val = rng.integers(0, 100, n).astype(np.int32)
        jres, jl = jstep(jnp.asarray(state),
                         jmake(jnp.asarray(tgt), jnp.asarray(val)), jl)
        tres, tl = tstep(torch.from_numpy(state),
                         tmake(torch.from_numpy(tgt),
                               torch.from_numpy(val)), tl)
        np.testing.assert_array_equal(tres.state.numpy(),
                                      np.asarray(jres.state))
        assert tl == int(jl)
        levels.append(tl)
    assert min(levels) == 0 and max(levels) == len(TAT.M_LADDER) - 1, levels


# -- the algorithms under backend="auto" ------------------------------------------


def _port(g):
    return to_graph(*[np.asarray(a) for a in (g.indptr, g.src, g.dst,
                                             g.weights)],
                    g.num_vertices, device="cpu")


def test_auto_matches_reference_on_all_six_algorithms(monkeypatch):
    """The reference's ``test_auto_matches_static_on_all_six_algorithms``
    with the port on the other side: both tuners deterministic
    (``REPRO_AUTOTUNE=off``), so both pick the same tier and ladder.
    The reference resolves its policy when it traces, and its jit cache
    does not key on the environment: a trace of the same graph and spec
    made earlier in the process with the tuner on would be reused, so
    the caches are cleared first (as the reference's
    ``test_durability.py`` does)."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    jax.clear_caches()
    g = JG.kronecker(7, 8, seed=3)
    gw = JG.random_weights(g, seed=4)
    tg, tgw = _port(g), _port(gw)
    src = int(np.argmax(np.asarray(g.degrees)))
    t = int(np.argmin(np.asarray(g.degrees)))
    ja, ta = JSpec(backend="auto", stats=False), \
        TSpec(backend="auto", stats=False)

    np.testing.assert_array_equal(TB.bfs(tg, src, spec=ta).dist.numpy(),
                                  np.asarray(JB.bfs(g, src, spec=ja).dist))
    jd, jr = JS.sssp(gw, src, spec=ja)
    td, tr = TS.sssp(tgw, src, spec=ta)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tr == int(jr)
    jp, jc = JP.pagerank(g, iters=5, spec=ja)
    tp, tc = TP.pagerank(tg, iters=5, spec=ta)
    np.testing.assert_allclose(tp.numpy() * g.num_vertices,
                               np.asarray(jp) * g.num_vertices,
                               rtol=ADD_RTOL, atol=ADD_ATOL)
    assert int(tc) == int(jc)
    jcol, jro, _ = JC.coloring(g, seed=0, spec=ja)
    tcol, tro, _ = TC.coloring(tg, seed=0, spec=ta)
    np.testing.assert_array_equal(tcol.numpy(), np.asarray(jcol))
    assert int(tro) == int(jro)
    jb, tb = JBo.boruvka(gw, spec=ja), TBo.boruvka(tgw, spec=ta)
    np.testing.assert_array_equal(tb[0].numpy(), np.asarray(jb[0]))
    np.testing.assert_allclose(float(tb[1]), float(jb[1]), rtol=1e-5)
    assert int(tb[2]) == int(jb[2])
    jf, jfr = JST.st_connectivity(g, src, t, spec=ja)
    tf, tfr = TST.st_connectivity(tg, src, t, spec=ta)
    assert (bool(tf), int(tfr)) == (bool(jf), int(jfr))
    gu = JG.erdos_renyi(150, 5.0, seed=9)
    np.testing.assert_array_equal(
        TB.bfs(_port(gu), 0, spec=ta).dist.numpy(),
        np.asarray(JB.bfs(gu, 0, spec=ja).dist))


@functools.lru_cache(maxsize=None)
def _entries():
    """name -> f(spec) for every entry point of the six algorithm
    modules, on small graphs (world size 1 for the engine forms)."""
    g = JG.random_weights(JG.kronecker(6, 8, seed=2), seed=5)
    tg = _port(g)
    gs = to_graphset([(*(np.asarray(a) for a in (h.indptr, h.src, h.dst,
                                                  h.weights)),
                       h.num_vertices)
                      for h in (JG.random_weights(JG.kronecker(5, 4, seed=s),
                                                  seed=s)
                                for s in (1, 2))], device="cpu")
    src = int(np.argmax(np.asarray(g.degrees)))
    ss, ts = [src, 1, 2], [3, src, 40]
    mesh = make_mesh(device="cpu")
    cap = dict(capacity=64, max_subrounds=256)
    return {
        "bfs": lambda s: TB.bfs(tg, src, spec=s).dist,
        "multi_source_bfs": lambda s: TB.multi_source_bfs(tg, ss,
                                                          spec=s).dist,
        "batched_over_graphs_bfs": lambda s: TB.batched_over_graphs_bfs(
            gs, [0, 1], spec=s),
        "batched_over_graphs_bfs(mesh=)":
            lambda s: TB.batched_over_graphs_bfs(gs, [0, 1], spec=s,
                                                 mesh=mesh, **cap),
        "distributed_bfs": lambda s: TB.distributed_bfs(mesh, tg, src,
                                                        spec=s, **cap),
        "distributed_multi_source_bfs":
            lambda s: TB.distributed_multi_source_bfs(mesh, tg, ss, spec=s,
                                                      **cap),
        "distributed_product_bfs": lambda s: TB.distributed_product_bfs(
            mesh, gs, [0, 1], spec=s, **cap),
        "sssp": lambda s: TS.sssp(tg, src, spec=s),
        "multi_source_sssp": lambda s: TS.multi_source_sssp(tg, ss, spec=s),
        "batched_over_graphs_sssp": lambda s: TS.batched_over_graphs_sssp(
            gs, [0, 1], spec=s),
        "distributed_sssp": lambda s: TS.distributed_sssp(mesh, tg, src,
                                                          spec=s, **cap),
        "distributed_multi_source_sssp":
            lambda s: TS.distributed_multi_source_sssp(mesh, tg, ss, spec=s,
                                                       **cap),
        "pagerank": lambda s: TP.pagerank(tg, iters=4, spec=s)[0],
        "personalized_pagerank": lambda s: TP.personalized_pagerank(
            tg, src, iters=4, spec=s)[0],
        "multi_source_pagerank": lambda s: TP.multi_source_pagerank(
            tg, ss, iters=4, spec=s)[0],
        "batched_over_graphs_pagerank":
            lambda s: TP.batched_over_graphs_pagerank(gs, [0, 1], iters=4,
                                                      spec=s),
        "batched_over_graphs_pagerank(mesh=)":
            lambda s: TP.batched_over_graphs_pagerank(
                gs, [0, 1], iters=4, spec=s, mesh=mesh, **cap),
        "distributed_pagerank": lambda s: TP.distributed_pagerank(
            mesh, tg, iters=4, spec=s, **cap),
        "distributed_multi_source_pagerank":
            lambda s: TP.distributed_multi_source_pagerank(
                mesh, tg, ss, iters=4, spec=s, **cap),
        "st_connectivity": lambda s: TST.st_connectivity(tg, src, 40,
                                                         spec=s),
        "multi_source_stconn": lambda s: TST.multi_source_stconn(
            tg, ss, ts, spec=s),
        "batched_over_graphs_stconn":
            lambda s: TST.batched_over_graphs_stconn(gs, [0, 1], [5, 9],
                                                     spec=s),
        "distributed_stconn": lambda s: TST.distributed_stconn(
            mesh, tg, src, 40, spec=s, **cap),
        "distributed_multi_source_stconn":
            lambda s: TST.distributed_multi_source_stconn(
                mesh, tg, ss, ts, spec=s, **cap),
        "coloring": lambda s: TC.coloring(tg, seed=1, spec=s),
        "batched_over_graphs_coloring":
            lambda s: TC.batched_over_graphs_coloring(gs, seed=1, spec=s),
        "distributed_coloring": lambda s: TC.distributed_coloring(
            mesh, tg, seed=1, spec=s, **cap),
        "boruvka": lambda s: TBo.boruvka(tg, spec=s),
        "batched_over_graphs_boruvka":
            lambda s: TBo.batched_over_graphs_boruvka(gs, spec=s),
        "batched_over_graphs_boruvka(mesh=)":
            lambda s: TBo.batched_over_graphs_boruvka(gs, spec=s, mesh=mesh,
                                                      **cap),
        "distributed_boruvka": lambda s: TBo.distributed_boruvka(
            mesh, tg, spec=s, **cap),
    }


ENTRIES = sorted(
    [f"{kind}{alg}" for alg in ("bfs", "sssp", "stconn", "coloring",
                                "boruvka", "pagerank")
     for kind in ("", "multi_source_", "batched_over_graphs_",
                  "distributed_", "distributed_multi_source_")
     if not (kind.endswith("multi_source_")
             and alg in ("coloring", "boruvka"))]
    + ["distributed_product_bfs", "personalized_pagerank",
       "batched_over_graphs_bfs(mesh=)", "batched_over_graphs_pagerank(mesh=)",
       "batched_over_graphs_boruvka(mesh=)"])
ENTRIES = ["st_connectivity" if e == "stconn" else e for e in ENTRIES]


def _same(got, exp, where):
    if isinstance(exp, (tuple, list)):
        assert len(got) == len(exp), where
        for i, (a, b) in enumerate(zip(got, exp)):
            _same(a, b, f"{where}[{i}]")
    elif isinstance(exp, torch.Tensor) and exp.is_floating_point():
        torch.testing.assert_close(got, exp, rtol=ADD_RTOL, atol=ADD_ATOL,
                                   msg=lambda m: f"{where}: {m}")
    elif isinstance(exp, torch.Tensor):
        assert torch.equal(got, exp), where
    else:
        assert got == exp, where


@pytest.mark.parametrize("entry", ENTRIES)
def test_every_entry_runs_auto_and_traced(entry, monkeypatch):
    """Each entry point under ``CommitSpec(backend="auto", trace=True)``
    equals its run on the static default tier, and the trace taps record
    its commits or rounds."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    run = _entries()[entry]
    exp = run(TSpec(backend="coarse", stats=False))
    wavetap.clear()
    got = run(TSpec(backend="auto", stats=False, trace=True))
    recs = wavetap.records()
    wavetap.clear()
    _same(got, exp, entry)
    kind = ("round" if entry.startswith("distributed") or "mesh=" in entry
            else "commit")
    assert recs and all(r["kind"] == kind for r in recs), entry


# -- the cache and the candidate set ----------------------------------------


def test_cache_round_trips_and_warm_tuner_times_nothing(tmp_path,
                                                        monkeypatch):
    path = tmp_path / "cache.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    spec = TSpec(backend="auto", stats=False)
    state = torch.zeros(256, dtype=torch.int32)
    cold = TAT.AutoTuner(**SMALL)
    pols = [TAT.policy_for(spec, state, n=n, op=op, tuner=cold)
            for n in (8, 5000) for op in ("min", "add")]
    assert cold.timed_runs > 0
    doc = json.loads(path.read_text())
    assert doc["schema"] == TAT.CACHE_SCHEMA
    assert all("|cpu|" in k for k in doc["entries"])
    warm = TAT.AutoTuner(**SMALL)
    again = [TAT.policy_for(spec, state, n=n, op=op, tuner=warm)
             for n in (8, 5000) for op in ("min", "add")]
    assert warm.timed_runs == 0 and again == pols
    assert warm.export_entries() == cold.export_entries()
    fresh = TAT.AutoTuner(**SMALL)
    fresh.import_entries({"race|x": "coarse", **cold.export_entries()})
    assert fresh.export_entries()["race|x"] == "coarse"


@pytest.mark.parametrize("content", ["{not json", '{"schema": "other/v0", '
                                     '"entries": {"cal|x": 1}}', "[1, 2]"])
def test_corrupt_cache_is_ignored(content, tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    path.write_text(content)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    tuner = TAT.AutoTuner(**SMALL)
    pol = TAT.policy_for(TSpec(backend="auto"),
                         torch.zeros(64, dtype=torch.int32), n=100,
                         tuner=tuner)
    assert pol.backend in ("atomic", "coarse") and tuner.timed_runs > 0
    assert json.loads(path.read_text())["schema"] == TAT.CACHE_SCHEMA


def test_kernel_tiers_excluded_on_the_cpu(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    tuner = TAT.AutoTuner(**SMALL)
    state = torch.zeros(128, dtype=torch.float32)
    msgs = tmake(torch.arange(32) % 128, torch.ones(32))
    TAT.policy_for(TSpec(backend="auto"), state, msgs, op="add",
                   tuner=tuner)
    events = [e["event"] for e in tuner.audit]
    assert events[0] == "kernel_tiers_excluded"
    cal = [e for e in tuner.audit if e["event"] == "calibrate"][0]
    assert set(cal["tiers"]) == {"atomic", "coarse"}
    assert tuner.audit[0]["escape_hatch"] == "REPRO_AUTOTUNE_ALLOW_INTERP"
    monkeypatch.setenv("REPRO_AUTOTUNE_ALLOW_INTERP", "1")
    hatch = TAT.AutoTuner(**SMALL)
    TAT.policy_for(TSpec(backend="auto"), state, msgs, op="add",
                   tuner=hatch)
    cal = [e for e in hatch.audit if e["event"] == "calibrate"][0]
    assert set(cal["tiers"]) == {"atomic", "coarse", "pallas", "fused"}
    assert "kernel_tiers_excluded" not in [e["event"] for e in hatch.audit]


def test_auto_commit_resolves_and_static_step_passes_level_through():
    spec = TSpec(backend="auto", seed_m=64)
    state = torch.full((32,), 1000, dtype=torch.int32)
    msgs = tmake(torch.tensor([3, 3, 5]), torch.tensor([7, 9, 1],
                                                       dtype=torch.int32))
    res = TAT.commit(state, msgs, "min", spec)
    assert res.state[[3, 5]].tolist() == [7, 1]
    step, lvl0 = TAT.make_commit_step(TSpec(backend="pallas"), "min", state)
    _, lvl = step(state, msgs, 3)
    assert (lvl0, lvl) == (0, 3)
