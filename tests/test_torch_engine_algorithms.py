"""The port's wave-engine forms of st-connectivity, coloring, Boruvka, the
lane forms of SSSP, PageRank and st-connectivity, the product-axis BFS
and the ``mesh=`` routes of the six ``batched_over_graphs_*``, against the
reference package on the CPU.

* World size 1: each against the reference's on a one-device mesh
  (``make_host_mesh(1, 1)``) on every commit backend at capacity 64,
  which a wave of these graphs overflows.  Outputs bit for bit (PageRank
  ranks scaled by V within rtol 2e-4 / atol 1e-6, the MST weight within
  rtol 1e-5), and the ``rounds``/``subrounds``/``conflicts``/
  ``delivered_all`` telemetry equal.  The reference's
  ``batched_over_graphs_coloring(mesh=...)`` fails on the installed jax,
  so that route is held to the reference's single-shard batched result.
* World sizes 2 and 4: gloo process groups on the CPU; every rank returns
  the same global result, equal to the reference's single-shard one, with
  every message delivered.
"""
import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.core.commit import CommitSpec as JSpec
from repro.graphs import generators as JG
from repro.graphs.algorithms import bfs as JB
from repro.graphs.algorithms import boruvka as JBo
from repro.graphs.algorithms import coloring as JC
from repro.graphs.algorithms import pagerank as JP
from repro.graphs.algorithms import sssp as JS
from repro.graphs.algorithms import stconn as JST
from repro.graphs.csr import GraphSet as JGraphSet
from repro.launch.mesh import make_host_mesh
from repro_torch.convert import to_graph, to_graphset
from repro_torch.core.commit import CommitSpec as TSpec
from repro_torch.graphs.algorithms import bfs as TB
from repro_torch.graphs.algorithms import boruvka as TBo
from repro_torch.graphs.algorithms import coloring as TC
from repro_torch.graphs.algorithms import pagerank as TP
from repro_torch.graphs.algorithms import sssp as TS
from repro_torch.graphs.algorithms import stconn as TST
from repro_torch.launch.mesh import make_mesh

ADD_RTOL, ADD_ATOL = 2e-4, 1e-6
MST_RTOL = 1e-5
BACKENDS = ["atomic", "coarse", "pallas", "fused"]
CAPACITY = 64
MAX_SUBROUNDS = 256
ITERS = 5                       # PageRank iterations
ENTRIES = ["stconn", "coloring", "boruvka", "multi_sssp", "multi_ppr",
           "multi_stconn", "product_bfs"]
GB_ALGS = ["bfs", "sssp", "ppr", "stconn", "coloring", "boruvka"]
PRODUCT_SOURCES = [[0, 3, 5], [1, 0, 20]]     # [L, G] graph-local ids
GB_SOURCES, GB_TARGETS = [0, 3, 5], [7, 0, 35]
SPAWN_TIMEOUT_S = 150


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each
    (a worker's default of one thread per core makes the port's small
    ops several times slower under the suite's load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(g):
    return [np.asarray(a) for a in (g.indptr, g.src, g.dst, g.weights)]


def _members(graphs):
    return [_arrays(g) + [g.num_vertices] for g in graphs]


@functools.lru_cache(maxsize=None)
def _graph():
    """(reference graph, its arrays, lane sources, lane targets): a
    weighted Kronecker scale-7 graph; the last lane pair is disconnected
    (an isolated target)."""
    g = JG.random_weights(JG.kronecker(7, 8, seed=3), seed=4)
    deg = np.asarray(g.degrees)
    hub, lone = int(np.argmax(deg)), int(np.flatnonzero(deg == 0)[0])
    return g, _arrays(g), [hub, 3, 9, hub], [17, 3, 40, lone]


@functools.lru_cache(maxsize=None)
def _tenants(weighted: bool):
    """Three tenant graphs of unequal sizes (32, 50, 36 vertices)."""
    graphs = [JG.kronecker(5, 4, seed=1), JG.erdos_renyi(50, 3.0, seed=2),
              JG.grid2d(6)]
    if weighted:
        graphs = [JG.random_weights(g, seed=i) for i, g in enumerate(graphs)]
    return tuple(graphs)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _run(entry, pkg, mesh, g, spec, capacity, ss, ts):
    """(outputs as a tuple of numpy arrays and ints, DistributedResult) of
    one distributed entry point of the reference (``pkg`` = "j") or the
    port ("t") on its graph ``g``."""
    if pkg == "j":
        ST, CO, BO, S, P, B = JST, JC, JBo, JS, JP, JB
        gs = JGraphSet(_tenants(False))
        lanes_ss, lanes_ts = (jnp.asarray(ss, jnp.int32),
                              jnp.asarray(ts, jnp.int32))
    else:
        ST, CO, BO, S, P, B = TST, TC, TBo, TS, TP, TB
        gs = to_graphset(_members(_tenants(False)), device="cpu")
        lanes_ss, lanes_ts = ss, ts
    kw = dict(spec=spec, capacity=capacity, max_subrounds=MAX_SUBROUNDS,
              telemetry=True)
    if entry == "stconn":
        *out, res = ST.distributed_stconn(mesh, g, ss[0], ts[0], **kw)
    elif entry == "coloring":
        *out, res = CO.distributed_coloring(mesh, g, seed=1, **kw)
    elif entry == "boruvka":
        *out, res = BO.distributed_boruvka(mesh, g, **kw)
    elif entry == "multi_sssp":
        *out, res = S.distributed_multi_source_sssp(mesh, g, lanes_ss, **kw)
    elif entry == "multi_ppr":
        rank, res = P.distributed_multi_source_pagerank(
            mesh, g, lanes_ss, iters=ITERS, **kw)
        out = [rank]
    elif entry == "multi_stconn":
        *out, res = ST.distributed_multi_source_stconn(mesh, g, lanes_ss,
                                                       lanes_ts, **kw)
    else:
        src = (jnp.asarray(PRODUCT_SOURCES, jnp.int32) if pkg == "j"
               else PRODUCT_SOURCES)
        *out, res = B.distributed_product_bfs(mesh, gs, src, **kw)
    return tuple(_np(o) if not isinstance(o, int) else o for o in out), res


def _check(entry, got, exp, num_vertices):
    if entry == "multi_ppr":
        np.testing.assert_allclose(got[0] * num_vertices,
                                   exp[0] * num_vertices, rtol=ADD_RTOL,
                                   atol=ADD_ATOL)
        return
    if entry == "boruvka":           # (comp, weight, n_edges, rounds)
        np.testing.assert_allclose(float(got[1]), float(exp[1]),
                                   rtol=MST_RTOL)
        got, exp = got[:1] + got[2:], exp[:1] + exp[2:]
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _telemetry(res):
    return (int(res.rounds), int(res.subrounds), int(res.conflicts),
            bool(res.delivered_all))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_world_size_1_matches_reference(entry, backend):
    g, arrays, ss, ts = _graph()
    tg = to_graph(*arrays, g.num_vertices, device="cpu")
    exp, jres = _run(entry, "j", make_host_mesh(1, 1), g,
                     JSpec(backend=backend), CAPACITY, ss, ts)
    got, tres = _run(entry, "t", make_mesh(device="cpu"), tg,
                     TSpec(backend=backend), CAPACITY, ss, ts)
    _check(entry, got, exp, g.num_vertices)
    assert _telemetry(tres) == _telemetry(jres)
    assert tres.delivered_all and tres.subrounds > tres.rounds


def _batched(alg, pkg, gs, spec, mesh):
    """One ``batched_over_graphs_*`` of the reference or the port, its
    per-member outputs as numpy arrays (and the fused round count where
    the entry returns one)."""
    mods = dict(zip(("B", "S", "P", "ST", "CO", "BO"),
                    (JB, JS, JP, JST, JC, JBo) if pkg == "j"
                    else (TB, TS, TP, TST, TC, TBo)))
    kw = dict(spec=spec)
    if mesh is not None:
        kw.update(mesh=mesh, capacity=CAPACITY, max_subrounds=MAX_SUBROUNDS)
    if alg == "bfs":
        return [_np(r) for r in mods["B"].batched_over_graphs_bfs(
            gs, GB_SOURCES, **kw)]
    if alg == "sssp":
        return [_np(r) for r in mods["S"].batched_over_graphs_sssp(
            gs, GB_SOURCES, **kw)]
    if alg == "ppr":
        return [_np(r) for r in mods["P"].batched_over_graphs_pagerank(
            gs, GB_SOURCES, iters=ITERS, **kw)]
    if alg == "stconn":
        return [_np(mods["ST"].batched_over_graphs_stconn(
            gs, GB_SOURCES, GB_TARGETS, **kw))]
    if alg == "coloring":
        colors, rounds, nc = mods["CO"].batched_over_graphs_coloring(
            gs, seed=2, **kw)
        return [_np(c) for c in colors] + [_np(nc), int(rounds)]
    out, rounds = mods["BO"].batched_over_graphs_boruvka(gs, **kw)
    return [_np(c) for c, _, _ in out] + [
        np.asarray([int(n) for _, _, n in out]),
        np.asarray([float(w) for _, w, _ in out]), int(rounds)]


def _check_batched(alg, got, exp, sizes):
    if alg == "ppr":
        for a, b, v in zip(got, exp, sizes):
            np.testing.assert_allclose(a * v, b * v, rtol=ADD_RTOL,
                                       atol=ADD_ATOL)
        return
    if alg == "boruvka":            # ..., weights, rounds
        np.testing.assert_allclose(got[-2], exp[-2], rtol=MST_RTOL)
        got, exp = got[:-2] + got[-1:], exp[:-2] + exp[-1:]
    assert len(got) == len(exp)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("alg", GB_ALGS)
def test_batched_over_graphs_mesh_route_world_size_1(alg):
    """The ``mesh=`` route at capacity 64 against the reference's own mesh
    route (coloring: its single-shard batched run)."""
    graphs = _tenants(alg in ("sssp", "boruvka"))
    spec = dict(backend="coarse")
    jmesh = None if alg == "coloring" else make_host_mesh(1, 1)
    exp = _batched(alg, "j", JGraphSet(graphs), JSpec(**spec), jmesh)
    tgs = to_graphset(_members(graphs), device="cpu")
    got = _batched(alg, "t", tgs, TSpec(**spec), make_mesh(device="cpu"))
    _check_batched(alg, got, exp, tgs.vsizes)


# -- world sizes 2 and 4 over gloo ------------------------------------------

GLOO_CASES = [("coarse", 16), ("fused", 4096)]


def _gloo_rank(rank, world, store_path, out_dir):
    """One rank of a gloo run: every entry point and ``mesh=`` route on
    every case of ``GLOO_CASES``, results saved to
    ``out_dir/rank<r>.npz``."""
    import torch.distributed as dist
    torch.set_num_threads(1)      # ranks share the host's cores
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(group=dist.group.WORLD, device="cpu")
        g, arrays, ss, ts = _graph()
        tg = to_graph(*arrays, g.num_vertices, device="cpu")
        out = {}
        for backend, cap in GLOO_CASES:
            spec = TSpec(backend=backend)
            for entry in ENTRIES:
                arrs, res = _run(entry, "t", mesh, tg, spec, cap, ss, ts)
                for i, a in enumerate(arrs):
                    out[f"{entry}-{backend}-{i}"] = np.asarray(a)
                out[f"{entry}-{backend}-delivered"] = np.asarray(
                    res.delivered_all)
            for alg in GB_ALGS:
                tgs = to_graphset(_members(_tenants(alg in ("sssp",
                                                            "boruvka"))),
                                  device="cpu")
                for i, a in enumerate(_batched(alg, "t", tgs, spec, mesh)):
                    out[f"gb_{alg}-{backend}-{i}"] = np.asarray(a)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# the leading outputs of each entry that the single-shard run also gives
# (the lane and two-wave forms may count their rounds otherwise)
GLOO_KEPT = {"stconn": 1, "coloring": 3, "boruvka": 4, "multi_sssp": 1,
             "multi_ppr": 1, "multi_stconn": 1, "product_bfs": 1}


@functools.lru_cache(maxsize=None)
def _single_shard_reference():
    """The reference's single-shard results of every entry, in the
    layout of ``_run``/``_batched``."""
    g, _, ss, ts = _graph()
    spec = JSpec(backend="coarse", stats=False)
    gs = JGraphSet(_tenants(False))
    jss, jts = jnp.asarray(ss, jnp.int32), jnp.asarray(ts, jnp.int32)
    exp = {
        "stconn": JST.st_connectivity(g, ss[0], ts[0], spec=spec)[:1],
        "coloring": JC.coloring(g, seed=1, spec=spec),
        "boruvka": JBo.boruvka(g, spec=spec),
        "multi_sssp": JS.multi_source_sssp(g, jss, spec=spec)[:1],
        "multi_ppr": JP.multi_source_pagerank(g, jss, iters=ITERS,
                                              spec=spec)[:1],
        "multi_stconn": JST.multi_source_stconn(g, jss, jts,
                                                spec=spec)[:1],
        # lane l of the product BFS: row l's G queries, one per graph
        "product_bfs": (np.stack([np.concatenate(
            JB.batched_over_graphs_bfs(gs, row, spec=spec))
            for row in PRODUCT_SOURCES]),),
    }
    exp = {k: tuple(_np(x) for x in v) for k, v in exp.items()}
    gb = {alg: _batched(alg, "j", JGraphSet(_tenants(alg in (
        "sssp", "boruvka"))), spec, None) for alg in GB_ALGS}
    return g.num_vertices, exp, gb


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_world_sizes_match_single_shard(world, tmp_path):
    v, exp, gb = _single_shard_reference()
    ctx = mp.start_processes(
        _gloo_rank, args=(world, str(tmp_path / "store"), str(tmp_path)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"gloo run of {world} ranks did not finish in "
                            f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = [dict(np.load(tmp_path / f"rank{r}.npz"))
               for r in range(world)]
    for key, arr in results[0].items():
        for r in range(1, world):
            np.testing.assert_array_equal(results[r][key], arr, err_msg=key)
    out = results[0]
    sizes = [g.num_vertices for g in _tenants(False)]
    for backend, _ in GLOO_CASES:
        for entry, kept in GLOO_KEPT.items():
            assert out[f"{entry}-{backend}-delivered"], entry
            got = tuple(out[f"{entry}-{backend}-{i}"] for i in range(kept))
            _check(entry, got, exp[entry][:kept], v)
        for alg in GB_ALGS:
            got = [out[f"gb_{alg}-{backend}-{i}"]
                   for i in range(len(gb[alg]))]
            _check_batched(alg, got, gb[alg], sizes)
