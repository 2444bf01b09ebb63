"""The port's graph batch axis and the remaining lane forms against the
reference package on the CPU.

* ``GraphSet``: sizes, offsets, the union's arrays, the flat-vertex map,
  the splits and the graph-of-vertex/edge maps equal the reference's;
  ``convert.to_graphset`` builds the same set.
* The six ``batched_over_graphs_*`` on three tenants of unequal sizes on
  every backend: each member bit for bit equal to the reference's batched
  run and to the port's own single-graph run (PageRank ranks scaled by
  the member's V within rtol 2e-4 / atol 1e-6; the MST weight within
  rtol 1e-5 of the reference's, equal to the port's single-graph one).
* ``multi_source_pagerank`` and ``multi_source_stconn`` against the
  reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.commit import CommitSpec as JSpec
from repro.graphs import generators as JG
from repro.graphs.algorithms import bfs as JB
from repro.graphs.algorithms import boruvka as JBo
from repro.graphs.algorithms import coloring as JC
from repro.graphs.algorithms import pagerank as JP
from repro.graphs.algorithms import sssp as JS
from repro.graphs.algorithms import stconn as JST
from repro.graphs.csr import GraphSet as JGraphSet
from repro_torch.convert import to_graph, to_graphset
from repro_torch.core.coalescing import GraphBatch
from repro_torch.core.commit import CommitSpec as TSpec
from repro_torch.graphs.algorithms import bfs as TB
from repro_torch.graphs.algorithms import boruvka as TBo
from repro_torch.graphs.algorithms import coloring as TC
from repro_torch.graphs.algorithms import pagerank as TP
from repro_torch.graphs.algorithms import sssp as TS
from repro_torch.graphs.algorithms import stconn as TST
from repro_torch.graphs.csr import GraphSet

ADD_RTOL, ADD_ATOL = 2e-4, 1e-6
MST_RTOL = 1e-5
BACKENDS = [("atomic", None), ("coarse", 16), ("pallas", None),
            ("fused", None), (None, None)]
BACKEND_IDS = ["atomic", "coarse-m16", "pallas", "fused", "default"]
ALGS = ("bfs", "sssp", "ppr", "stconn", "coloring", "boruvka")
SOURCES = [0, 3, 5]
TARGETS = [7, 0, 35]
ITERS = 5


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


def _port(g):
    return to_graph(*_arrays(g), g.num_vertices, device="cpu")


def _tenants(weighted=False):
    """Three tenants of unequal sizes and degree regimes: power-law,
    uniform, lattice (32, 50 and 36 vertices)."""
    gs = [JG.kronecker(5, 4, seed=1), JG.erdos_renyi(50, 3.0, seed=2),
          JG.grid2d(6)]
    if weighted:
        gs = [JG.random_weights(g, seed=i) for i, g in enumerate(gs)]
    return gs


def _sets(weighted=False):
    graphs = _tenants(weighted)
    return (JGraphSet(graphs),
            to_graphset([_arrays(g) + [g.num_vertices] for g in graphs],
                        device="cpu"))


def _specs(backend, m):
    if backend is None:
        return None, None
    kw = dict(backend=backend, m=m, stats=False, tile_m=128)
    return JSpec(**kw), TSpec(**kw)


def test_graphset_fields_and_splits():
    jgs, tgs = _sets(weighted=True)
    assert (tgs.num_graphs, tgs.num_vertices, tgs.num_edges) == (
        jgs.num_graphs, jgs.num_vertices, jgs.num_edges)
    assert (tgs.vsizes, tgs.esizes) == (jgs.vsizes, jgs.esizes)
    np.testing.assert_array_equal(tgs.voffs, jgs.voffs)
    np.testing.assert_array_equal(tgs.eoffs, jgs.eoffs)
    assert [tgs.vertex_offset(i) for i in range(3)] == [
        jgs.vertex_offset(i) for i in range(3)]
    assert tgs.axis == GraphBatch(sizes=jgs.axis.sizes)
    ju, tu = jgs.union(), tgs.union()
    assert tu is tgs.union()                    # cached
    assert (tu.num_vertices, tu.num_edges) == (ju.num_vertices, ju.num_edges)
    for exp, got in zip(_arrays(ju), (tu.indptr, tu.src, tu.dst,
                                       tu.weights)):
        assert got.device.type == "cpu" and str(got.dtype) == \
            f"torch.{exp.dtype}"
        np.testing.assert_array_equal(got.numpy(), exp)
    for name in ("graph_of_vertex", "graph_of_edge"):
        got = getattr(tgs, name)()
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jgs, name)()))
    flat = tgs.flat_vertices(SOURCES)
    assert flat.dtype == torch.int32
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(jgs.flat_vertices(SOURCES)))
    vals = np.arange(jgs.num_vertices)
    for got, exp in zip(tgs.split_vertex(torch.from_numpy(vals)),
                        jgs.split_vertex(vals)):
        np.testing.assert_array_equal(got.numpy(), exp)
    vals = np.arange(jgs.num_edges)
    for got, exp in zip(tgs.split_edge(torch.from_numpy(vals)),
                        jgs.split_edge(vals)):
        np.testing.assert_array_equal(got.numpy(), exp)
    with pytest.raises(ValueError, match="one vertex per graph"):
        tgs.flat_vertices([0, 1])
    with pytest.raises(ValueError, match="at least one graph"):
        GraphSet([])


def _check_batched(alg, backend, m, mesh=None):
    """Each member of the port's batched run equals the reference's
    batched run (``jrun``) and the port's single-graph run."""
    js, ts = _specs(backend, m)
    jgs, tgs = _sets(weighted=alg in ("sssp", "boruvka"))
    tkw = {} if mesh is None else dict(mesh=mesh, capacity=64,
                                       max_subrounds=256)
    if alg == "bfs":
        exp = JB.batched_over_graphs_bfs(jgs, SOURCES, spec=js)
        got = TB.batched_over_graphs_bfs(tgs, SOURCES, spec=ts, **tkw)
        one = [TB.bfs(g, s, spec=ts).dist for g, s in zip(tgs.graphs,
                                                           SOURCES)]
    elif alg == "sssp":
        exp = JS.batched_over_graphs_sssp(jgs, SOURCES, spec=js)
        got = TS.batched_over_graphs_sssp(tgs, SOURCES, spec=ts, **tkw)
        one = [TS.sssp(g, s, spec=ts)[0] for g, s in zip(tgs.graphs,
                                                          SOURCES)]
    elif alg == "ppr":
        exp = JP.batched_over_graphs_pagerank(jgs, SOURCES, iters=ITERS,
                                              spec=js)
        got = TP.batched_over_graphs_pagerank(tgs, SOURCES, iters=ITERS,
                                              spec=ts, **tkw)
        one = [TP.personalized_pagerank(g, s, iters=ITERS, spec=ts)[0]
               for g, s in zip(tgs.graphs, SOURCES)]
        for g, e, gt, o in zip(tgs.graphs, exp, got, one):
            v = g.num_vertices
            np.testing.assert_allclose(gt.numpy() * v, np.asarray(e) * v,
                                       rtol=ADD_RTOL, atol=ADD_ATOL)
            np.testing.assert_allclose(gt.numpy() * v, o.numpy() * v,
                                       rtol=ADD_RTOL, atol=ADD_ATOL)
        return
    elif alg == "stconn":
        exp = JST.batched_over_graphs_stconn(jgs, SOURCES, TARGETS, spec=js)
        got = TST.batched_over_graphs_stconn(tgs, SOURCES, TARGETS, spec=ts,
                                             **tkw)
        assert got.dtype == torch.bool and got.shape == (3,)
        one = [TST.st_connectivity(g, s, t, spec=ts)[0] for g, s, t in
               zip(tgs.graphs, SOURCES, TARGETS)]
        assert got.tolist() == np.asarray(exp).tolist() == [
            bool(x) for x in one] == [
            TST.st_reference(g, s, t) for g, s, t in
            zip(tgs.graphs, SOURCES, TARGETS)]
        return
    elif alg == "coloring":
        jc, jr, jn = JC.batched_over_graphs_coloring(jgs, seed=2, spec=js)
        tc, tr, tn = TC.batched_over_graphs_coloring(tgs, seed=2, spec=ts,
                                                     **tkw)
        assert tr == int(jr)
        assert tn.tolist() == np.asarray(jn).tolist() == [False] * 3
        for g, e, gt in zip(tgs.graphs, jc, tc):
            one, _, _ = TC.coloring(g, seed=2, spec=ts)
            np.testing.assert_array_equal(gt.numpy(), np.asarray(e))
            assert torch.equal(gt, one) and TC.validate_coloring(g, gt)
        return
    else:
        jout, jr = JBo.batched_over_graphs_boruvka(jgs, spec=js)
        tout, tr = TBo.batched_over_graphs_boruvka(tgs, spec=ts, **tkw)
        assert tr == int(jr)
        for g, (jcomp, jw, jn), (comp, w, n) in zip(tgs.graphs, jout, tout):
            np.testing.assert_array_equal(comp.numpy(), np.asarray(jcomp))
            assert int(n) == int(jn)
            np.testing.assert_allclose(float(w), float(jw), rtol=MST_RTOL)
            comp1, w1, n1, _ = TBo.boruvka(g, spec=ts)
            assert torch.equal(comp, comp1) and int(n) == int(n1)
            assert float(w) == float(w1)
        return
    for e, gt, o in zip(exp, got, one):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(e))
        assert torch.equal(gt, o)


@pytest.mark.parametrize("backend,m", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("alg", ALGS)
def test_batched_over_graphs_parity(alg, backend, m):
    _check_batched(alg, backend, m)


@pytest.mark.parametrize("backend,m", BACKENDS, ids=BACKEND_IDS)
def test_multi_source_pagerank_parity(backend, m):
    g = _tenants()[0]
    tg = _port(g)
    js, ts = _specs(backend, m)
    sources = [0, 5, 17, 5]
    jr, jc = JP.multi_source_pagerank(g, jnp.asarray(sources, jnp.int32),
                                      iters=ITERS, spec=js)
    tr, tc = TP.multi_source_pagerank(tg, sources, iters=ITERS, spec=ts)
    v = g.num_vertices
    assert tr.shape == (4, v) and tr.dtype == torch.float32
    np.testing.assert_allclose(tr.numpy() * v, np.asarray(jr) * v,
                               rtol=ADD_RTOL, atol=ADD_ATOL)
    assert int(tc) == int(jc)
    for lane, s in enumerate(sources):
        one, _ = TP.personalized_pagerank(tg, s, iters=ITERS, spec=ts)
        np.testing.assert_allclose(tr[lane].numpy() * v, one.numpy() * v,
                                   rtol=ADD_RTOL, atol=ADD_ATOL)


@pytest.mark.parametrize("backend,m", BACKENDS, ids=BACKEND_IDS)
def test_multi_source_stconn_parity(backend, m):
    """Connected, disconnected (an isolated vertex) and s == t lanes."""
    g = JG.kronecker(6, 4, seed=2)
    tg = _port(g)
    js, ts = _specs(backend, m)
    deg = np.asarray(g.degrees)
    hub, lone = int(np.argmax(deg)), int(np.flatnonzero(deg == 0)[0])
    ss, tt = [hub, hub, 3, lone], [1, lone, 3, hub]
    jf, jr = JST.multi_source_stconn(g, jnp.asarray(ss, jnp.int32),
                                     jnp.asarray(tt, jnp.int32), spec=js)
    tf, tr = TST.multi_source_stconn(tg, ss, tt, spec=ts)
    assert tf.dtype == torch.bool
    assert tf.tolist() == np.asarray(jf).tolist()
    assert tr == int(jr)
    assert tf.tolist() == [TST.st_reference(tg, s, t)
                           for s, t in zip(ss, tt)]
    assert tf[1].item() is False and tf[2].item() is True
