"""The port's wave engine against the reference package.

* World size 1: the port's ``distributed_bfs``, ``distributed_sssp``,
  ``distributed_pagerank`` and ``distributed_multi_source_bfs`` against
  the reference's on a one-device mesh (``make_host_mesh(1, 1)``), on
  each commit backend and coalescing capacity.  Arrays and the
  ``rounds``/``subrounds``/``conflicts``/``delivered_all`` telemetry
  must be equal; PageRank ranks scaled by V within rtol 2e-4 / atol 1e-6
  (the reference's reassociation bound).
* World sizes 2 and 4: gloo process groups on the CPU
  (``torch.multiprocessing`` spawn, a ``FileStore``); every rank must
  return the same global state, equal to the reference's single-shard
  results.  The reference's own multi-device meshes fail on the
  installed jax, so they are not the oracle here.
* The single-shard lane forms ``multi_source_bfs``/``multi_source_sssp``
  against the reference's.
"""
import functools
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.core.commit import CommitSpec as JSpec
from repro.graphs import generators as JG
from repro.graphs.algorithms import bfs as JB
from repro.graphs.algorithms import pagerank as JP
from repro.graphs.algorithms import sssp as JS
from repro.core import engine as JE
from repro.launch.mesh import make_host_mesh
from repro_torch.convert import to_graph
from repro_torch.core import engine as TE
from repro_torch.core.commit import CommitSpec as TSpec
from repro_torch.graphs.algorithms import bfs as TB
from repro_torch.graphs.algorithms import pagerank as TP
from repro_torch.graphs import csr as TCSR
from repro_torch.graphs.algorithms import sssp as TS
from repro_torch.launch.mesh import make_mesh

ADD_RTOL, ADD_ATOL = 2e-4, 1e-6
BACKENDS = ["atomic", "coarse", "pallas", "fused"]
ENTRIES = ["bfs", "sssp", "pagerank", "multi_bfs"]
MAX_SUBROUNDS = 256       # a capacity-16 wave of kronecker(8, 8) needs ~60
ITERS = 5                 # PageRank iterations
SPAWN_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each
    (a worker's default of one thread per core makes the port's small
    ops several times slower under the suite's load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _graph(name):
    """(reference graph, port graph on the CPU, source vertex)."""
    g = (JG.kronecker(8, 8, seed=1) if name == "kron8"
         else JG.random_weights(JG.grid2d(10), seed=3))
    return g, _port(g), int(np.argmax(np.asarray(g.degrees)))


def _arrays(g):
    return [np.asarray(a) for a in (g.indptr, g.src, g.dst, g.weights)]


def _port(g):
    return to_graph(*_arrays(g), g.num_vertices, device="cpu")


def _lanes(src):
    return [src, 1, 7]


def _run(entry, mod, mesh, g, src, **kw):
    """(output as numpy, DistributedResult) of one entry point of the
    reference (``mod`` = "j") or the port ("t")."""
    bfs, sssp, pr = (JB, JS, JP) if mod == "j" else (TB, TS, TP)
    kw = dict(kw, telemetry=True)
    if entry == "bfs":
        out, _, res = bfs.distributed_bfs(mesh, g, src, **kw)
    elif entry == "sssp":
        out, _, res = sssp.distributed_sssp(mesh, g, src, **kw)
    elif entry == "pagerank":
        out, res = pr.distributed_pagerank(mesh, g, iters=ITERS, **kw)
    else:
        out, _, res = bfs.distributed_multi_source_bfs(mesh, g, _lanes(src),
                                                       **kw)
    return (out.numpy() if isinstance(out, torch.Tensor)
            else np.asarray(out)), res


def _check(entry, got, exp, num_vertices):
    if entry == "pagerank":
        np.testing.assert_allclose(got * num_vertices, exp * num_vertices,
                                   rtol=ADD_RTOL, atol=ADD_ATOL)
    else:
        np.testing.assert_array_equal(got, exp)


def _telemetry(res):
    return (int(res.rounds), int(res.subrounds), int(res.conflicts),
            bool(res.delivered_all))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("capacity", [16, 64, 4096])
@pytest.mark.parametrize("graph", ["kron8", "grid-w"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_world_size_1_matches_reference(entry, graph, capacity, backend):
    g, tg, src = _graph(graph)
    kw = dict(capacity=capacity, max_subrounds=MAX_SUBROUNDS)
    exp, jres = _run(entry, "j", make_host_mesh(1, 1), g, src,
                     spec=JSpec(backend=backend), **kw)
    got, tres = _run(entry, "t", make_mesh(device="cpu"), tg, src,
                     spec=TSpec(backend=backend), **kw)
    _check(entry, got, exp, g.num_vertices)
    assert _telemetry(tres) == _telemetry(jres)
    assert tres.delivered_all
    assert (tres.m_final, tres.capacity, tres.degraded) == (-1, capacity,
                                                            False)


@pytest.mark.parametrize("entry", ENTRIES)
def test_wedge_reports_undelivered(entry):
    """One sub-round per wave at capacity 16: both packages stop with
    messages pending and say so, with the same partial state."""
    g, tg, src = _graph("kron8")
    kw = dict(capacity=16, max_subrounds=1)
    exp, jres = _run(entry, "j", make_host_mesh(1, 1), g, src,
                     spec=JSpec(backend="fused", stats=False), **kw)
    got, tres = _run(entry, "t", make_mesh(device="cpu"), tg, src,
                     spec=TSpec(backend="fused", stats=False), **kw)
    assert not jres.delivered_all and not tres.delivered_all
    assert _telemetry(tres) == _telemetry(jres)
    _check(entry, got, exp, g.num_vertices)


def test_default_spec_and_auto_capacity():
    """``spec=None`` is the coarse tier with stats; ``capacity="auto"``
    takes the reference's heuristic and constants."""
    g, tg, src = _graph("kron8")
    exp, jres = _run("bfs", "j", make_host_mesh(1, 1), g, src,
                     capacity="auto")
    got, tres = _run("bfs", "t", make_mesh(device="cpu"), tg, src,
                     capacity="auto")
    np.testing.assert_array_equal(got, exp)
    assert _telemetry(tres) == _telemetry(jres)
    assert tres.capacity == int(jres.capacity)
    assert (TE.CAPACITY_MIN, TE.CAPACITY_MAX, TE.OVERFLOW_RATIO) == (
        64, 1 << 15, 2.0)
    assert TE.auto_capacity(tg, 1) == min(
        1 << (2 * tg.num_edges - 1).bit_length(), TE.CAPACITY_MAX)


def _tree_algorithm(mod):
    """A two-round algorithm of the reference (``mod`` = "j") or the port
    ("t") whose waves carry a dict state and payload (``min`` on an int32
    and a float32 field, one bucket plan) and whose rounds read the
    committed field back at every edge's source with ``rt.gather``."""
    import jax.numpy as jnp
    Spec = JE.AlgorithmSpec if mod == "j" else TE.AlgorithmSpec

    def init(g, layout):
        vpad, ne = layout.vpad, layout.num_shards * layout.emax
        full = (lambda n, v, dt: jnp.full((n,), v, dt)) if mod == "j" else (
            lambda n, v, dt: torch.full((n,), v, dtype=dt))
        i32, f32, b = ((jnp.int32, jnp.float32, bool) if mod == "j"
                       else (torch.int32, torch.float32, torch.bool))
        return {"a": full(vpad, 2 ** 30, i32), "b": full(vpad, 1e30, f32),
                "got": full(ne, 0, i32), "won": full(ne, False, b)}, {}

    def round_fn(rt, e, st, sc, it):
        valid = e.valid & ((e.eid % 3) != it)
        new, succ = rt.wave({"a": st["a"], "b": st["b"]}, e.dst,
                            {"a": e.eid + it, "b": e.weight * (it + 1)},
                            valid, op="min")
        got = rt.gather(new["a"], e.src, valid, fill=-1)
        state = dict(new, got=got, won=succ["a"] & succ["b"])
        return state, sc, jnp.asarray(it < 1) if mod == "j" else it < 1

    return Spec("tree_wave", "FR&MF", init, round_fn,
                lambda g, layout: 2)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("capacity", [16, 4096])
def test_tree_payload_wave_and_gather(capacity, backend):
    """Several fields through one bucket plan, their success flags back by
    one reverse exchange, and the remote gather, against the
    reference's harness."""
    g, tg, _ = _graph("grid-w")
    kw = dict(capacity=capacity, max_subrounds=MAX_SUBROUNDS)
    jres = JE.run_distributed(_tree_algorithm("j"), make_host_mesh(1, 1), g,
                              spec=JSpec(backend=backend), **kw)
    tres = TE.run_distributed(_tree_algorithm("t"), make_mesh(device="cpu"),
                              tg, spec=TSpec(backend=backend), **kw)
    for key in ("a", "b", "got", "won"):
        np.testing.assert_array_equal(tres.state[key].numpy(),
                                      np.asarray(jres.state[key]), key)
    assert _telemetry(tres) == _telemetry(jres)
    assert tres.delivered_all


def test_unported_modes_raise():
    _, tg, _ = _graph("kron8")
    with pytest.raises(NotImplementedError, match="Graph"):
        TE.run_distributed(None, make_mesh(device="cpu"), [tg, tg])


def test_make_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, {"data": 1})


def test_engine_config_takes_its_shard_count_from_the_mesh():
    ecfg = TE.EngineConfig(make_mesh(device="cpu"), 8, 4)
    assert ecfg.num_shards == 1
    with pytest.raises(TypeError):
        TE.EngineConfig(8, 4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_multi_source_single_shard(backend):
    g, tg, src = _graph("grid-w")
    sources = _lanes(src)
    kw = dict(backend=backend, stats=False, tile_m=128)
    jr = JB.multi_source_bfs(g, np.asarray(sources, np.int32),
                             spec=JSpec(**kw))
    tr = TB.multi_source_bfs(tg, sources, spec=TSpec(**kw))
    np.testing.assert_array_equal(tr.dist.numpy(), np.asarray(jr.dist))
    assert tr.rounds == int(jr.rounds)
    assert int(tr.messages) == int(jr.messages)
    for lane, s in enumerate(sources):
        np.testing.assert_array_equal(tr.dist[lane].numpy(),
                                      TB.bfs(tg, s, spec=TSpec(**kw))
                                      .dist.numpy())
    jd, jrounds = JS.multi_source_sssp(g, np.asarray(sources, np.int32),
                                       spec=JSpec(**kw))
    td, trounds = TS.multi_source_sssp(tg, sources, spec=TSpec(**kw))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert trounds == int(jrounds)


# -- world sizes 2 and 4 over gloo ------------------------------------------

GLOO_CASES = [("coarse", 16), ("fused", 16), ("pallas", 4096)]


def _gloo_rank(rank, world, store_path, out_dir, arrays, num_vertices, src):
    """One rank of a gloo run: every entry point on every case of
    ``GLOO_CASES``, results saved to ``out_dir/rank<r>.npz``."""
    import torch.distributed as dist
    torch.set_num_threads(1)      # ranks share the host's cores
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(group=dist.group.WORLD, device="cpu")
        assert (mesh.size, mesh.rank) == (world, rank)
        g = to_graph(*arrays, num_vertices, device="cpu")
        out = {}
        for backend, cap in GLOO_CASES:
            for entry in ENTRIES:
                arr, res = _run(entry, "t", mesh, g, src,
                                spec=TSpec(backend=backend), capacity=cap,
                                max_subrounds=MAX_SUBROUNDS)
                key = f"{entry}-{backend}-{cap}"
                out[key] = arr
                out[key + "-telemetry"] = np.asarray(_telemetry(res))
        res = TE.run_distributed(_tree_algorithm("t"), mesh, g,
                                 spec=TSpec(backend="fused"), capacity=16,
                                 max_subrounds=MAX_SUBROUNDS)
        for field in ("a", "b", "got"):
            out[f"tree-{field}"] = res.state[field].numpy()
        out["tree-telemetry"] = np.asarray(_telemetry(res))
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _single_shard_reference():
    g = JG.random_weights(JG.kronecker(8, 8, seed=1), seed=3)
    src = int(np.argmax(np.asarray(g.degrees)))
    spec = JSpec(backend="coarse", stats=False)
    exp = {"bfs": np.asarray(JB.bfs(g, src, spec=spec).dist),
           "sssp": np.asarray(JS.sssp(g, src, spec=spec)[0]),
           "pagerank": np.asarray(JP.pagerank(g, iters=ITERS,
                                              spec=spec)[0]),
           "multi_bfs": np.asarray(JB.multi_source_bfs(
               g, np.asarray(_lanes(src), np.int32), spec=spec).dist)}
    tree = JE.run_distributed(_tree_algorithm("j"), make_host_mesh(1, 1), g,
                              spec=JSpec(backend="fused"), capacity=16,
                              max_subrounds=MAX_SUBROUNDS)
    exp["tree"] = {k: np.asarray(tree.state[k]) for k in ("a", "b")}
    return g, src, exp


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_world_sizes_match_single_shard(world, tmp_path):
    g, src, exp = _single_shard_reference()
    ctx = mp.start_processes(
        _gloo_rank, args=(world, str(tmp_path / "store"), str(tmp_path),
                          _arrays(g), g.num_vertices, src),
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
    (src_p, _, _, val_p, eid_p), _ = TCSR.partition_edges(_port(g), world)
    a = exp["tree"]["a"]
    # the last round's gather of "a" at each edge's source, in the layout
    # of `world` ranks
    exp = dict(exp, tree=dict(exp["tree"], got=np.where(
        val_p & (eid_p % 3 != 1), a[src_p], -1).reshape(-1)))
    for key, arr in results[0].items():
        for r in range(1, world):
            np.testing.assert_array_equal(results[r][key], arr, err_msg=key)
        entry, field = key.split("-")[0], key.split("-")[-1]
        if key.endswith("telemetry"):
            assert arr[3] == 1, f"{key}: not every message was delivered"
        elif entry == "tree":      # V = 256: no padding at 2 or 4 ranks
            np.testing.assert_array_equal(arr, exp["tree"][field],
                                          err_msg=key)
        else:
            _check(entry, arr, exp[entry], g.num_vertices)
