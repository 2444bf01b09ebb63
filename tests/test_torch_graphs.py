"""The port's graph generators and BFS/SSSP/PageRank against the
reference package.

Generators must build identical arrays from the same seed.  Algorithms
run on the same graph (the reference's arrays carried across with
``repro_torch.convert``) on each commit backend of both packages: BFS and
SSSP distances bit-identical, BFS rounds/messages/conflicts/applied
equal, PageRank within rtol 2e-4 / atol 1e-6.
"""
import numpy as np
import pytest
import torch

from repro.core.commit import CommitSpec as JSpec
from repro.graphs import generators as JG
from repro.graphs.algorithms import bfs as JB
from repro.graphs.algorithms import pagerank as JP
from repro.graphs.algorithms import sssp as JS
from repro_torch.convert import to_graph
from repro_torch.core.commit import CommitSpec as TSpec
from repro_torch.graphs import generators as TG
from repro_torch.graphs.algorithms import bfs as TB
from repro_torch.graphs.algorithms import pagerank as TP
from repro_torch.graphs.algorithms import sssp as TS

BACKENDS = [("atomic", None), ("coarse", 64), ("pallas", None),
            ("fused", None)]
BACKEND_IDS = ["atomic", "coarse-m64", "pallas", "fused"]
GRAPHS = {"kron8": lambda: JG.kronecker(8, 8, seed=1),
          "grid": lambda: JG.grid2d(12)}


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


def _specs(backend, m):
    kw = dict(backend=backend, m=m, stats=False, tile_m=128)
    return JSpec(**kw), TSpec(**kw)


def _source(g):
    return int(np.argmax(np.asarray(g.degrees)))


@pytest.mark.parametrize("name,make", [
    ("kronecker", lambda M, dev: M.kronecker(8, 8, seed=1, **dev)),
    ("kronecker_ef16", lambda M, dev: M.kronecker(6, 16, seed=0, **dev)),
    ("erdos_renyi", lambda M, dev: M.erdos_renyi(300, 6.0, seed=2, **dev)),
    ("grid2d", lambda M, dev: M.grid2d(12, **dev)),
    ("preferential", lambda M, dev: M.preferential(200, 3, seed=3, **dev)),
    ("bipartite_web", lambda M, dev: M.bipartite_web(300, 16, 6.0, seed=4,
                                                    **dev)),
    ("random_weights", lambda M, dev: M.random_weights(
        M.grid2d(9, **dev), seed=7)),
] + [(f"table1-{k}", (lambda k: lambda M, dev: M.TABLE1_FAMILIES[k](
    300, seed=5, **dev))(k)) for k in JG.TABLE1_FAMILIES])
def test_generators_build_identical_arrays(name, make):
    jg = make(JG, {})
    tg = make(TG, {"device": "cpu"})
    assert (tg.num_vertices, tg.num_edges) == (jg.num_vertices,
                                               jg.num_edges)
    for exp, got in zip(_arrays(jg), (tg.indptr, tg.src, tg.dst,
                                       tg.weights)):
        np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("backend,m", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_bfs_parity(graph, backend, m):
    g = GRAPHS[graph]()
    js, ts = _specs(backend, m)
    src = _source(g)
    jr = JB.bfs(g, src, spec=js)
    tr = TB.bfs(_port(g), src, spec=ts)
    np.testing.assert_array_equal(tr.dist.numpy(), np.asarray(jr.dist))
    assert tr.rounds == int(jr.rounds)
    for field in ("messages", "conflicts", "applied"):
        assert int(getattr(tr, field)) == int(getattr(jr, field)), field
    np.testing.assert_array_equal(tr.dist.numpy(),
                                  TB.bfs_reference(_port(g), src))


@pytest.mark.parametrize("backend,m", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_sssp_parity(graph, backend, m):
    g = JG.random_weights(GRAPHS[graph](), seed=7)
    js, ts = _specs(backend, m)
    src = _source(g)
    jd, jrounds = JS.sssp(g, src, spec=js)
    td, trounds = TS.sssp(_port(g), src, spec=ts)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert trounds == int(jrounds)


@pytest.mark.parametrize("backend,m", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_pagerank_parity(graph, backend, m):
    g = GRAPHS[graph]()
    js, ts = _specs(backend, m)
    jr, jc = JP.pagerank(g, iters=15, spec=js)
    tr, tc = TP.pagerank(_port(g), iters=15, spec=ts)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=2e-4,
                               atol=1e-6)
    assert int(tc) == int(jc)
    src = _source(g)
    jr, _ = JP.personalized_pagerank(g, src, iters=15, spec=js)
    tr, _ = TP.personalized_pagerank(_port(g), src, iters=15, spec=ts)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=2e-4,
                               atol=1e-6)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_reference_oracles_match(graph):
    g = JG.random_weights(GRAPHS[graph](), seed=7)
    tg = _port(g)
    src = _source(g)
    np.testing.assert_array_equal(TB.bfs_reference(tg, src),
                                  JB.bfs_reference(g, src))
    np.testing.assert_array_equal(TS.sssp_reference(tg, src),
                                  JS.sssp_reference(g, src))
    np.testing.assert_array_equal(TP.pagerank_reference(tg, iters=10),
                                  JP.pagerank_reference(g, iters=10))
    ref_rank = TP.pagerank_reference(tg, iters=15)
    rank, _ = TP.pagerank(tg, iters=15, spec=TSpec(backend="pallas",
                                                   stats=False))
    np.testing.assert_allclose(rank.numpy(), ref_rank, atol=1e-5)
    assert abs(float(rank.sum()) - 1.0) < 1e-3
