"""The port's resumable product wave (``repro_torch.serve.product_wave``)
against the reference package's on the CPU.

* For each of the four product kinds, a partly occupied 2-lane wave over
  three tenants on each port backend answers every cell as the
  reference's wave on the same ``GraphSet`` does (BFS, SSSP and
  st-connectivity bit for bit, PPR within rtol 2e-4 / atol 1e-6), with
  the same row dtypes; a query inserted at round k of a running wave
  equals its idle run.
* ``done_cells`` (one host read for every cell) equals ``cell_done``
  cell by cell at every round boundary.
* ``release`` lets a slot be reused; graph-only kinds are refused.
* A row from ``extract`` is a copy: a later ``release`` and ``insert``
  into the same cell leave it as it was.
"""
import numpy as np
import pytest
import torch

from repro.core.commit import CommitSpec as JSpec
from repro.graphs import generators as JG
from repro.graphs.csr import GraphSet as JGraphSet
from repro.serve import product_wave as JPW
from repro.serve import queries as JQ
from repro_torch.convert import to_graphset
from repro_torch.core.commit import CommitSpec as TSpec
from repro_torch.serve import product_wave as TPW
from repro_torch.serve import queries as TQ
from repro_torch.serve.queries import PRODUCT_KINDS

ADD_RTOL, ADD_ATOL = 2e-4, 1e-6
BACKENDS = ("atomic", "coarse", "pallas", "fused")
ITERS = 6


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
def _no_tuner_files(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "off")
    monkeypatch.delenv("REPRO_TRACE", raising=False)


def _graphs():
    return [JG.random_weights(g, seed=i) for i, g in enumerate(
        (JG.kronecker(5, 6, seed=3), JG.erdos_renyi(40, 4.0, seed=9),
         JG.erdos_renyi(24, 3.0, seed=1)))]


def _sets():
    graphs = _graphs()
    return JGraphSet(graphs), to_graphset(
        [[np.asarray(a) for a in (g.indptr, g.src, g.dst, g.weights)]
         + [g.num_vertices] for g in graphs], device="cpu")


def _cells(kind, Q):
    if kind == "bfs":
        return [(0, 0, Q.BfsQuery(1)), (1, 0, Q.BfsQuery(5)),
                (0, 1, Q.BfsQuery(0)), (1, 2, Q.BfsQuery(7))]
    if kind == "sssp":
        return [(0, 0, Q.SsspQuery(2)), (1, 1, Q.SsspQuery(8)),
                (0, 2, Q.SsspQuery(3))]
    if kind == "ppr":
        return [(0, 0, Q.PprQuery(2, iters=ITERS)),
                (1, 2, Q.PprQuery(3, iters=ITERS)),
                (0, 1, Q.PprQuery(0, iters=ITERS))]
    return [(0, 0, Q.StConnQuery(0, 17)), (1, 1, Q.StConnQuery(2, 2)),
            (0, 2, Q.StConnQuery(0, 23)), (1, 0, Q.StConnQuery(3, 30))]


def _fuse(kind):
    return {"iters": ITERS, "d": 0.85} if kind == "ppr" else {}


def _check(kind, got, want):
    if kind == "stconn":
        assert type(got) is bool and got == want
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    if kind == "ppr":
        np.testing.assert_allclose(got, want, rtol=ADD_RTOL, atol=ADD_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


_REF = {}


def _ref_rows(kind):
    """The reference wave's answer for every cell (memoised: its chunks
    compile once per kind)."""
    if kind not in _REF:
        jgs, _ = _sets()
        wave = JPW.ProductWave(kind, jgs, 2,
                               spec=JSpec(backend="atomic", stats=False),
                               fuse=_fuse(kind))
        for lane, g, q in _cells(kind, JQ):
            wave.insert(lane, g, q)
        wave.run()
        _REF[kind] = [wave.extract(lane, g)
                      for lane, g, _ in _cells(kind, JQ)]
    return _REF[kind]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", PRODUCT_KINDS)
def test_product_wave_matches_reference(kind, backend):
    _, tgs = _sets()
    wave = TPW.ProductWave(kind, tgs, 2,
                           spec=TSpec(backend=backend, stats=False),
                           fuse=_fuse(kind))
    for lane, g, q in _cells(kind, TQ):
        wave.insert(lane, g, q)
    wave.run()
    assert wave.done
    flags = wave.done_cells()
    for (lane, g, _), want in zip(_cells(kind, TQ), _ref_rows(kind)):
        assert wave.cell_done(lane, g) and flags[lane, g]
        _check(kind, wave.extract(lane, g), want)


@pytest.mark.parametrize("kind", PRODUCT_KINDS)
def test_insert_mid_run_equals_idle_run(kind):
    """A cell inserted at round 2 of a RUNNING wave (the continuous-
    batching boarding step) answers as an idle run does: the
    reference's idle wave, and the port's own.  At every boundary
    ``done_cells`` agrees with ``cell_done``."""
    _, tgs = _sets()
    spec = TSpec(backend="coarse", stats=False)
    cells = _cells(kind, TQ)
    wave = TPW.ProductWave(kind, tgs, 2, spec=spec, fuse=_fuse(kind),
                           round_chunk=2)
    lane0, g0, q0 = cells[0]
    wave.insert(lane0, g0, q0)
    wave.run_chunk()                       # 2 rounds in
    for lane, g, q in cells[1:]:
        wave.insert(lane, g, q)            # board the running wave
    while True:
        flags = wave.done_cells()
        for lane in range(2):
            for g in range(3):
                assert flags[lane, g] == wave.cell_done(lane, g)
        if wave.run_chunk():
            break
    assert wave.rounds > 2
    idle = TPW.ProductWave(kind, tgs, 2, spec=spec, fuse=_fuse(kind))
    for lane, g, q in cells:
        idle.insert(lane, g, q)
    idle.run()
    for (lane, g, _), want in zip(cells, _ref_rows(kind)):
        _check(kind, wave.extract(lane, g), want)
        _check(kind, wave.extract(lane, g), np.asarray(
            idle.extract(lane, g)) if kind != "stconn"
            else idle.extract(lane, g))


def test_release_reuses_slot():
    _, tgs = _sets()
    jgs, _ = _sets()
    wave = TPW.ProductWave("bfs", tgs, 1, round_chunk=3)
    wave.insert(0, 0, TQ.BfsQuery(1))
    wave.run()
    first = wave.extract(0, 0)
    wave.release(0, 0)
    assert wave.done and not wave.occupied.any()
    assert not wave.done_cells().any()
    wave.insert(0, 0, TQ.BfsQuery(9))
    wave.run()
    ref = JPW.ProductWave("bfs", jgs, 1, round_chunk=3)
    ref.insert(0, 0, JQ.BfsQuery(9))
    ref.run()
    _check("bfs", wave.extract(0, 0), ref.extract(0, 0))
    assert not torch.equal(wave.extract(0, 0), first)


def test_graph_only_kinds_refused():
    _, tgs = _sets()
    for kind in ("coloring", "mst"):
        with pytest.raises(ValueError, match="no lane form"):
            TPW.ProductWave(kind, tgs, 2)


@pytest.mark.parametrize("kind", PRODUCT_KINDS)
def test_extract_is_a_copy(kind):
    """The continuous loop publishes and caches ``extract``'s row, then
    releases the cell and may board a new query into it: the published
    row must not change."""
    _, tgs = _sets()
    cells = _cells(kind, TQ)
    wave = TPW.ProductWave(kind, tgs, 2,
                           spec=TSpec(backend="pallas", stats=False),
                           fuse=_fuse(kind))
    lane, g, q = cells[0]
    wave.insert(lane, g, q)
    wave.run()
    row = wave.extract(lane, g)
    kept = row.clone() if isinstance(row, torch.Tensor) else row
    wave.release(lane, g)
    other = cells[1][2] if kind != "stconn" else TQ.StConnQuery(5, 6)
    wave.insert(lane, g, other)
    wave.run()
    if isinstance(row, torch.Tensor):
        assert torch.equal(row, kept)
        assert not torch.equal(wave.extract(lane, g), row)
    else:
        assert row == kept
