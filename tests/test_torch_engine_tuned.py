"""The wave engine's tuned and degraded paths and the ownership protocol
against the reference package on the CPU.

* World size 1, ``CommitSpec(backend="auto")`` (both tuners
  deterministic, ``REPRO_AUTOTUNE=off``): the port's ``distributed_*``
  against the reference's on a one-device mesh: state, ``m_final``,
  conflicts, sub-rounds.
* Degraded-mesh mode at world size 1: a fault retries the snapshot in
  place, equal to the clean run and to the reference's degraded run, with
  ``degraded`` set and a ``mesh_shrink`` instant traced; more than
  ``max_faults`` faults raise.
* ``run_transactions`` at world size 1 equal to the reference's
  (``visited``, ``rounds``, ``retries``, ``bids``).
* Four gloo ranks (``torch.multiprocessing`` spawn, a ``FileStore``, one
  torch thread per rank): BFS and Boruvka with a fault at chunk 1 shrink
  to three ranks (Boruvka restarting from round 0) and equal the
  single-shard reference on every rank, the dropped one included;
  ``run_transactions`` over ``txns[4, X, K]`` equals the reference at one
  device on the same transactions as ``[1, 4X, K]``.  The reference's own
  multi-device meshes fail on the installed jax, so they are not the
  oracle here.
"""
import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.core.commit import CommitSpec as JSpec
from repro.core.ownership import run_transactions as j_run_transactions
from repro.graphs import generators as JG
from repro.graphs.algorithms import bfs as JB
from repro.graphs.algorithms import boruvka as JBo
from repro.graphs.algorithms import pagerank as JP
from repro.graphs.algorithms import sssp as JS
from repro.launch.mesh import make_host_mesh
from repro_torch.convert import to_graph
from repro_torch.core import engine as TE
from repro_torch.core.commit import CommitSpec as TSpec
from repro_torch.core.ownership import run_transactions
from repro_torch.graphs.algorithms import bfs as TB
from repro_torch.graphs.algorithms import boruvka as TBo
from repro_torch.graphs.algorithms import pagerank as TP
from repro_torch.graphs.algorithms import sssp as TS
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import trace as TT

ADD_RTOL, ADD_ATOL = 2e-4, 1e-6
SPAWN_TIMEOUT_S = 120
WORLD = 4
CAP = dict(capacity=64, max_subrounds=256)
TXN = dict(X=8, K=3, V=40, seed=7)


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
def _deterministic_tuner(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "off")
    monkeypatch.delenv("REPRO_TRACE", raising=False)


@functools.lru_cache(maxsize=None)
def _graph():
    """(reference graph, its arrays, source vertex)."""
    g = JG.random_weights(JG.kronecker(8, 8, seed=1), seed=3)
    arrays = [np.asarray(a) for a in (g.indptr, g.src, g.dst, g.weights)]
    return g, arrays, int(np.argmax(np.asarray(g.degrees)))


def _port(arrays, v):
    return to_graph(*arrays, v, device="cpu")


def _run(entry, mod, mesh, g, src, **kw):
    bfs, sssp, pr = (JB, JS, JP) if mod == "j" else (TB, TS, TP)
    kw = dict(kw, telemetry=True)
    if entry == "bfs":
        out, _, res = bfs.distributed_bfs(mesh, g, src, **kw)
    elif entry == "sssp":
        out, _, res = sssp.distributed_sssp(mesh, g, src, **kw)
    elif entry == "pagerank":
        out, res = pr.distributed_pagerank(mesh, g, iters=5, **kw)
    else:
        out, _, res = bfs.distributed_multi_source_bfs(mesh, g, [src, 1, 7],
                                                       **kw)
    return np.asarray(out.numpy() if isinstance(out, torch.Tensor)
                      else out), res


def _check(entry, got, exp, v):
    if entry == "pagerank":
        np.testing.assert_allclose(got * v, exp * v, rtol=ADD_RTOL,
                                   atol=ADD_ATOL)
    else:
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("entry", ["bfs", "sssp", "pagerank", "multi_bfs"])
def test_auto_world_size_1_matches_reference(entry, stats):
    g, arrays, src = _graph()
    exp, jres = _run(entry, "j", make_host_mesh(1, 1), g, src,
                     spec=JSpec(backend="auto", stats=stats), **CAP)
    got, tres = _run(entry, "t", make_mesh(device="cpu"),
                     _port(arrays, g.num_vertices), src,
                     spec=TSpec(backend="auto", stats=stats), **CAP)
    _check(entry, got, exp, g.num_vertices)
    assert (tres.rounds, tres.subrounds, int(tres.conflicts), tres.m_final,
            tres.delivered_all) == \
        (int(jres.rounds), int(jres.subrounds), int(jres.conflicts),
         int(jres.m_final), bool(jres.delivered_all))
    assert tres.m_final >= 0 and not tres.degraded and tres.shards == 1


def _drop_at_chunk_1(chunk, rounds_done):
    """The fault of these tests: the host drop before chunk 1 (once: the
    chunk count moves on after a fault)."""
    if chunk == 1:
        raise RuntimeError("simulated host drop")


@pytest.mark.parametrize("entry", ["bfs", "multi_bfs"])
def test_degraded_world_size_1_retries_in_place(entry, monkeypatch):
    monkeypatch.setenv("REPRO_TRACE", "1")
    g, arrays, src = _graph()
    tg = _port(arrays, g.num_vertices)
    tracer = TT.Tracer(enabled=True)
    TT.set_tracer(tracer)
    try:
        clean, cres = _run(entry, "t", make_mesh(device="cpu"), tg, src,
                           spec=TSpec(backend="coarse"), **CAP)
        got, tres = _run(entry, "t", make_mesh(device="cpu"), tg, src,
                         spec=TSpec(backend="coarse"), snapshot_rounds=2,
                         fault_injector=_drop_at_chunk_1, **CAP)
    finally:
        TT.set_tracer(None)
    exp, jres = _run(entry, "j", make_host_mesh(1, 1), g, src,
                     spec=JSpec(backend="coarse"), snapshot_rounds=2,
                     fault_injector=_drop_at_chunk_1, **CAP)
    np.testing.assert_array_equal(got, clean)
    np.testing.assert_array_equal(got, exp)
    assert tres.degraded and bool(jres.degraded) and not cres.degraded
    assert (tres.rounds, tres.subrounds, int(tres.conflicts)) == \
        (cres.rounds, cres.subrounds, int(cres.conflicts)) == \
        (int(jres.rounds), int(jres.subrounds), int(jres.conflicts))
    (shrink,) = [e for e in tracer.events if e["name"] == "mesh_shrink"]
    assert {k: shrink["args"][k] for k in ("P", "survivors", "rounds_done",
                                           "faults")} == \
        {"P": 1, "survivors": 1, "rounds_done": 2, "faults": 1}
    assert TT.validate_trace(tracer.to_chrome()) == []


def test_degraded_boruvka_world_size_1_equals_the_clean_run():
    g, arrays, src = _graph()
    tg = _port(arrays, g.num_vertices)
    mesh = make_mesh(device="cpu")
    clean = TBo.distributed_boruvka(mesh, tg, spec=TSpec(backend="pallas"),
                                    **CAP)
    chunked = TBo.distributed_boruvka(mesh, tg, spec=TSpec(backend="pallas"),
                                      snapshot_rounds=1,
                                      fault_injector=_drop_at_chunk_1,
                                      telemetry=True, **CAP)
    assert torch.equal(chunked[0], clean[0]) and chunked[3] == clean[3]
    assert float(chunked[1]) == float(clean[1]) and chunked[-1].degraded


def test_past_max_faults_raises():
    g, arrays, _ = _graph()
    seen = []

    def always(chunk, rounds_done):
        seen.append(chunk)
        raise RuntimeError(f"fault {chunk}")

    def init(g, layout):
        return {"x": torch.zeros(layout.vpad)}, {}

    alg = TE.AlgorithmSpec("noop", "FF&AS", init,
                           lambda rt, e, st, sc, it: (st, sc, False),
                           lambda g, layout: 4)
    with pytest.raises(RuntimeError, match="fault 3"):
        TE.run_distributed(alg, make_mesh(device="cpu"),
                           _port(arrays, g.num_vertices),
                           fault_injector=always, max_faults=3)
    assert seen == [0, 1, 2, 3]


def _txns(P, X, K, V, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, V, (P, X, K)).astype(np.int32)


def _j_txn_run(txns, V, capacity):
    visited, st = j_run_transactions(make_host_mesh(1, 1),
                                     jnp.asarray(txns), V,
                                     capacity=capacity)
    return (np.asarray(visited),
            (int(st.rounds), int(st.retries), int(st.bids)))


@pytest.mark.parametrize("X,K,V,capacity", [(32, 6, 64, 512),
                                            (16, 4, 200, 16),
                                            (8, 3, 9, 64)])
def test_run_transactions_world_size_1_matches_reference(X, K, V, capacity):
    txns = _txns(1, X, K, V, seed=X + K)
    exp, jst = _j_txn_run(txns, V, capacity)
    visited, st = run_transactions(make_mesh(device="cpu"),
                                   torch.from_numpy(txns), V,
                                   capacity=capacity)
    np.testing.assert_array_equal(visited.numpy(), exp)
    assert (st.rounds, st.retries, st.bids) == jst
    want = np.zeros(V, bool)
    want[txns.reshape(-1)] = True
    np.testing.assert_array_equal(exp, want)
    assert st.retries > 0 or X * K <= V


def test_run_transactions_rejects_keys_past_int32():
    with pytest.raises(ValueError, match="total"):
        run_transactions(make_mesh(device="cpu"),
                         torch.zeros((1, 50000, 2), dtype=torch.int32), 8)


# -- four gloo ranks ----------------------------------------------------------


def _gloo_rank(rank, world, store_path, out_dir, arrays, num_vertices, src,
               txns):
    """One rank: degraded BFS and Boruvka (4 -> 3 ranks), then
    ``run_transactions``; results saved to ``out_dir/rank<r>.npz``."""
    import torch.distributed as dist
    torch.set_num_threads(1)      # ranks share the host's cores
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(group=dist.group.WORLD, device="cpu")
        g = to_graph(*arrays, num_vertices, device="cpu")
        kw = dict(snapshot_rounds=2, fault_injector=_drop_at_chunk_1,
                  telemetry=True, **CAP)
        dist_, rounds, res = TB.distributed_bfs(
            mesh, g, src, spec=TSpec(backend="coarse"), **kw)
        out = {"bfs": dist_.numpy(),
               "bfs-meta": np.asarray([rounds, res.shards, res.degraded,
                                       res.delivered_all])}
        comp, weight, n_edges, rounds, res = TBo.distributed_boruvka(
            mesh, g, spec=TSpec(backend="fused"), **kw)
        out.update({"boruvka": comp.numpy(),
                    "boruvka-weight": np.asarray(float(weight)),
                    "boruvka-meta": np.asarray([int(n_edges), res.shards,
                                                res.degraded,
                                                res.delivered_all])})
        visited, st = run_transactions(mesh, torch.from_numpy(txns),
                                       TXN["V"], capacity=TXN["X"] * TXN["K"])
        out.update({"txn": visited.numpy(),
                    "txn-stats": np.asarray([st.rounds, st.retries,
                                             st.bids])})
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    g, arrays, src = _graph()
    txns = _txns(WORLD, TXN["X"], TXN["K"], TXN["V"], TXN["seed"])
    tmp = tmp_path_factory.mktemp("gloo")
    ctx = mp.start_processes(
        _gloo_rank, args=(WORLD, str(tmp / "store"), str(tmp), arrays,
                          g.num_vertices, src, txns),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"gloo run of {WORLD} ranks did not finish in "
                            f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)], \
        txns


def test_gloo_degraded_bfs_shrinks_and_matches_single_shard(gloo_results):
    results, _ = gloo_results
    g, _, src = _graph()
    exp = np.asarray(JB.bfs(g, src, spec=JSpec(backend="coarse")).dist)
    for r, out in enumerate(results):
        np.testing.assert_array_equal(out["bfs"], exp, err_msg=f"rank {r}")
        _, shards, degraded, delivered = out["bfs-meta"]
        assert (shards, degraded, delivered) == (WORLD - 1, 1, 1)
        np.testing.assert_array_equal(out["bfs-meta"],
                                      results[0]["bfs-meta"])


def test_gloo_degraded_boruvka_restarts_and_matches_single_shard(
        gloo_results):
    results, _ = gloo_results
    g, _, _ = _graph()
    comp, weight, n_edges, _ = JBo.boruvka(g, spec=JSpec(backend="coarse"))
    for r, out in enumerate(results):
        np.testing.assert_array_equal(out["boruvka"], np.asarray(comp),
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(float(out["boruvka-weight"]),
                                   float(weight), rtol=1e-5)
        assert tuple(out["boruvka-meta"]) == (int(n_edges), WORLD - 1, 1, 1)


def test_gloo_run_transactions_matches_reference_on_one_device(
        gloo_results):
    """Rank p's transactions have global ids p*X + x, so the four ranks'
    ``txns[4, X, K]`` are the one device's ``[1, 4X, K]``: the same keys,
    the same bids, the same rounds."""
    results, txns = gloo_results
    exp, jst = _j_txn_run(txns.reshape(1, -1, TXN["K"]), TXN["V"],
                          4 * TXN["X"] * TXN["K"])
    for r, out in enumerate(results):
        np.testing.assert_array_equal(out["txn"], exp, err_msg=f"rank {r}")
        assert tuple(out["txn-stats"]) == jst
    assert jst[1] > 0                     # conflicts happened
