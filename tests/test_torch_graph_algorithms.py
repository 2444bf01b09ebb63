"""The port's st-connectivity, coloring and Boruvka against the reference
package on the CPU.

Each runs on the same graph (the reference's arrays carried across with
``repro_torch.convert``) on every commit backend of both packages
(``coarse`` with m = 16 and with the whole batch as one transaction), and
with ``spec=None``, over five graph families.  Bit for bit: st-connectivity
``found`` and ``rounds``; coloring ``color``, ``rounds`` and
``not_converged``; Boruvka ``comp``, the per-direction selection,
``n_edges`` and ``rounds``.  The MST weight is an f32 sum in another order:
rtol 1e-5.  The uint32 hashes of coloring are held bit for bit, inputs near
2^32 - 1 included, and the port's SciPy ``mst_reference`` equal to the
reference's networkx one.
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
from repro.graphs.algorithms import stconn as JST
from repro.graphs.csr import GraphSet as JGraphSet
from repro_torch.convert import to_graph
from repro_torch.core.commit import CommitSpec as TSpec
from repro_torch.graphs.algorithms import boruvka as TBo
from repro_torch.graphs.algorithms import coloring as TC
from repro_torch.graphs.algorithms import stconn as TST

MST_RTOL = 1e-5
BACKENDS = [("atomic", None), ("coarse", 16), ("coarse", None),
            ("pallas", None), ("fused", None), (None, None)]
BACKEND_IDS = ["atomic", "coarse-m16", "coarse", "pallas", "fused",
               "default"]
FAMILIES = {
    "kron8": lambda: JG.kronecker(8, 8, seed=1),
    "grid": lambda: JG.grid2d(12),
    "erdos_renyi": lambda: JG.erdos_renyi(300, 6.0, seed=2),
    "preferential": lambda: JG.preferential(200, 3, seed=3),
    "bipartite_web": lambda: JG.bipartite_web(300, 16, 6.0, seed=4),
}


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
    if backend is None:
        return None, None
    kw = dict(backend=backend, m=m, stats=False, tile_m=128)
    return JSpec(**kw), TSpec(**kw)


@pytest.mark.parametrize("backend,m", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_stconn_parity(family, backend, m):
    """Connected (the farthest vertex BFS reaches), disconnected (a vertex
    of a 4 x 4 grid joined as a second component) and s == t."""
    g = JGraphSet([FAMILIES[family](), JG.grid2d(4)]).union()
    tg = _port(g)
    js, ts = _specs(backend, m)
    s = int(np.argmax(np.asarray(g.degrees)))
    dist = JB.bfs_reference(g, s)
    far = int(np.argmax(np.where(dist < 2 ** 29, dist, -1)))
    cases = {"connected": far, "disconnected": g.num_vertices - 1,
             "s == t": s}
    for case, t in cases.items():
        jf, jr = JST.st_connectivity(g, s, t, spec=js)
        tf, tr = TST.st_connectivity(tg, s, t, spec=ts)
        expect = case != "disconnected"
        assert bool(tf) == bool(jf) == expect, case
        assert tr == int(jr), case
        assert tf.dtype == torch.bool and tf.device.type == "cpu"
        assert TST.st_reference(tg, s, t) == JST.st_reference(g, s, t) \
            == expect, case


@pytest.mark.parametrize("backend,m", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_coloring_parity(family, backend, m):
    g = FAMILIES[family]()
    tg = _port(g)
    js, ts = _specs(backend, m)
    jc, jr, jn = JC.coloring(g, seed=3, spec=js)
    tc, tr, tn = TC.coloring(tg, seed=3, spec=ts)
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tr == int(jr)
    assert bool(tn) == bool(jn) is False
    assert TC.validate_coloring(tg, tc) and JC.validate_coloring(g, jc)


@pytest.mark.parametrize("backend,m", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_boruvka_parity(family, backend, m):
    g = JG.random_weights(FAMILIES[family](), seed=7)
    tg = _port(g)
    js, ts = _specs(backend, m)
    jcomp, jsel, jr = JBo.boruvka_forest(g, spec=js)
    tcomp, tsel, tr = TBo.boruvka_forest(tg, spec=ts)
    assert tcomp.dtype == torch.int32
    np.testing.assert_array_equal(tcomp.numpy(), np.asarray(jcomp))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    assert tr == int(jr)
    _, jw, jn, _ = JBo.boruvka(g, spec=js)
    comp, tw, tn, tr2 = TBo.boruvka(tg, spec=ts)
    assert torch.equal(comp, tcomp) and tr2 == tr
    assert int(tn) == int(jn) and tn.dtype == torch.int32
    np.testing.assert_allclose(float(tw), float(jw), rtol=MST_RTOL)
    np.testing.assert_allclose(float(tw), TBo.mst_reference(tg),
                               rtol=MST_RTOL)


NEAR_TOP = [0, 1, 2, 3, 0xFFFF, 0x10000, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1,
            0x7feb352d, 0x846ca68b, 2 ** 32 - 3, 2 ** 32 - 2, 2 ** 32 - 1]
SEEDS = [0, 1, 7, 138547331]        # seed * 31 + 7 stays below 2^32
ROUNDS = [0, 1, 2, 499, 2 ** 31 - 1]


def _u32_inputs(n=4096):
    rng = np.random.default_rng(11)
    return np.concatenate([np.asarray(NEAR_TOP, np.int64),
                           rng.integers(0, 2 ** 32, n, dtype=np.int64)])


def test_hash32_bit_equality():
    x = _u32_inputs()
    exp = np.asarray(JC._hash32(jnp.asarray(x.astype(np.uint32))))
    got = TC._hash32(torch.from_numpy(x))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), exp.astype(np.int64))
    for v in NEAR_TOP:     # the scalar form the round mixes use
        assert TC._hash32(v) == int(JC._hash32(jnp.uint32(v)))


@pytest.mark.parametrize("seed", SEEDS)
def test_pair_loser_bit_equality(seed):
    rng = np.random.default_rng(seed)
    top = np.asarray([0, 1, 2 ** 31 - 2, 2 ** 31 - 1], np.int32)
    src = np.concatenate([np.repeat(top, 4), rng.integers(
        0, 2 ** 31, 2048, dtype=np.int64).astype(np.int32)])
    dst = np.concatenate([np.tile(top, 4), rng.integers(
        0, 2 ** 31, 2048, dtype=np.int64).astype(np.int32)])
    for rnd in ROUNDS:
        exp = np.asarray(JC._pair_loser(jnp.asarray(src), jnp.asarray(dst),
                                        seed, rnd))
        got = TC._pair_loser(torch.from_numpy(src), torch.from_numpy(dst),
                             seed, rnd)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), exp, err_msg=str(rnd))


@pytest.mark.parametrize("seed", SEEDS)
def test_propose_bit_equality(seed):
    ids = _u32_inputs(2048)
    rng = np.random.default_rng(seed + 1)
    active = rng.random(ids.shape[0]) < 0.7
    color = rng.integers(0, 50, ids.shape[0]).astype(np.int32)
    pal_v = rng.integers(1, 2 ** 31, ids.shape[0]).astype(np.int64)
    for rnd in ROUNDS:
        for pal in (1, 7, 2 ** 31 - 1, pal_v):
            jpal = (jnp.asarray(pal.astype(np.uint32))
                    if isinstance(pal, np.ndarray) else pal)
            tpal = torch.from_numpy(pal) if isinstance(pal, np.ndarray) \
                else pal
            exp = np.asarray(JC._propose(
                jnp.asarray(ids.astype(np.uint32)), jnp.asarray(active),
                jnp.asarray(color), jpal, seed, rnd))
            got = TC._propose(torch.from_numpy(ids),
                              torch.from_numpy(active),
                              torch.from_numpy(color), tpal, seed, rnd)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), exp,
                                          err_msg=f"rnd={rnd}")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_mst_reference_equals_networkx(family):
    """SciPy's Kruskal over the least weight of each undirected pair
    against the reference's networkx forest: equal, since both sum the
    same f32 weights in float64, where these sums are exact."""
    g = JG.random_weights(FAMILIES[family](), seed=5)
    assert TBo.mst_reference(_port(g)) == JBo.mst_reference(g)
    unit = FAMILIES[family]()
    assert TBo.mst_reference(_port(unit)) == JBo.mst_reference(unit)


def test_mst_reference_takes_the_lighter_direction():
    """A pair stored with two weights counts at its least one, as the
    reference keeps it."""
    src, dst = np.array([0, 1, 1, 2]), np.array([1, 0, 2, 1])
    w = np.array([5.0, 2.0, 1.0, 1.0], np.float32)
    tg = to_graph(np.array([0, 1, 3, 4]), src, dst, w, 3, device="cpu")
    assert TBo.mst_reference(tg) == 3.0
