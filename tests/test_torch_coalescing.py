"""The port's coalescing router, batch axes and edge partition against the
reference package.

Inputs come from fixed numpy seeds (parametrised, not hypothesis) and go
to both packages.  Key algebra, every :class:`BucketPlan` field, the
sort order, the bucket buffers and the partition arrays must be equal;
the reference's ``"pallas"`` count runs in interpret mode.  Batched
commits: state and success equal, float ``add`` within rtol 2e-4 /
atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coalescing as JC
from repro.core import commit as JCM
from repro.core import messages as JM
from repro.graphs import csr as JCSR
from repro.graphs import generators as JG
from repro_torch.convert import to_bucket_plan, to_graph
from repro_torch.core import coalescing as TC
from repro_torch.core import commit as TCM
from repro_torch.core import messages as TM
from repro_torch.graphs import csr as TCSR

FIELDS = ("owner", "position", "counts", "kept", "dropped")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each
    (a worker's default of one thread per core makes the port's small
    ops several times slower under the suite's load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _plans_eq(jp, tp):
    for f in FIELDS:
        _eq(getattr(jp, f), getattr(tp, f))


# -- key algebra -------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_fuse_split_keys(seed):
    rng = np.random.default_rng(seed)
    stride = int(rng.integers(1, 200))
    major = rng.integers(0, 50, 400).astype(np.int32)
    minor = rng.integers(0, stride, 400).astype(np.int32)
    key = rng.integers(-5000, 5000, 400).astype(np.int32)   # negatives too
    for jf, tf in ((JC.fuse_keys, TC.fuse_keys),
                   (JC.fuse_lane_keys, TC.fuse_lane_keys)):
        _eq(jf(jnp.asarray(major), jnp.asarray(minor), stride),
            tf(torch.from_numpy(major), torch.from_numpy(minor), stride))
    for jf, tf in ((JC.split_keys, TC.split_keys),
                   (JC.split_lane_keys, TC.split_lane_keys)):
        for a, b in zip(jf(jnp.asarray(key), stride),
                        tf(torch.from_numpy(key), stride)):
            _eq(a, b)


AXES = {
    "lanes": lambda M: M.QueryLanes(5, 37),
    "graphs": lambda M: M.GraphBatch((3, 7, 1, 12)),
    "product": lambda M: M.ProductAxis(3, (3, 7, 12)),
    "product-1lane": lambda M: M.ProductAxis(1, (4, 9)),
}


@pytest.mark.parametrize("name", list(AXES))
def test_batch_axis_keys(name):
    ja, ta = AXES[name](JC), AXES[name](TC)
    for prop in ("flat_size", "wave_width", "race_width"):
        assert getattr(ja, prop) == getattr(ta, prop)
    rng = np.random.default_rng(len(name))
    key = rng.integers(0, ja.flat_size, 300).astype(np.int32)
    for a, b in zip(ja.unflatten(jnp.asarray(key)),
                    ta.unflatten(torch.from_numpy(key))):
        _eq(a, b)
    major, minor = (_np(x) for x in ja.unflatten(jnp.asarray(key)))
    _eq(ja.flatten(jnp.asarray(major), jnp.asarray(minor)),
        ta.flatten(torch.from_numpy(major), torch.from_numpy(minor)))
    _eq(ta.flatten(*ta.unflatten(torch.from_numpy(key))), key)
    if name.startswith("product"):
        assert ja.offsets == ta.offsets
        assert ja.num_vertices == ta.num_vertices
        assert ja.num_graphs == ta.num_graphs
        parts = [_np(x) for x in ja.split3(jnp.asarray(key))]
        for a, b in zip(parts, ta.split3(torch.from_numpy(key))):
            _eq(a, b)
        _eq(ja.flatten3(*(jnp.asarray(p) for p in parts)),
            ta.flatten3(*(torch.from_numpy(p) for p in parts)))


def test_product_axis_degenerate_forms():
    sizes = (3, 7, 12)
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.integers(0, 3, 50))
    v = torch.from_numpy(rng.integers(0, 3, 50))
    _eq(TC.ProductAxis(1, sizes).flatten3(0, g, v),
        TC.GraphBatch(sizes).flatten(g, v))
    lane = torch.from_numpy(rng.integers(0, 4, 50))
    _eq(TC.ProductAxis(4, (11,)).flatten3(lane, 0, v),
        TC.QueryLanes(4, 11).flatten(lane, v))


def test_require_key_space_bound():
    for mod in (JC, TC):
        assert mod.MAX_FLAT_KEYS == 2 ** 31 - 2
        assert mod.require_key_space(2 ** 31 - 2, where="t") == 2 ** 31 - 2
        with pytest.raises(OverflowError, match="int32 key space"):
            mod.require_key_space(2 ** 31 - 1, where="t")
        with pytest.raises(OverflowError):
            mod.QueryLanes(2 ** 16, 2 ** 15)
        with pytest.raises(OverflowError):
            mod.ProductAxis(2 ** 10, (2 ** 20, 2 ** 20))
        for bad in (lambda: mod.QueryLanes(0, 5),
                    lambda: mod.GraphBatch(()),
                    lambda: mod.GraphBatch((3, 0)),
                    lambda: mod.ProductAxis(0, (3,))):
            with pytest.raises(ValueError):
                bad()


# -- the router --------------------------------------------------------------

PLAN_CASES = [(seed, nb, cap) for seed in (0, 1) for nb in (1, 7, 32, 33, 100)
              for cap in (1, 8, 1000)]


def _plan_inputs(seed, nb, n=300):
    rng = np.random.default_rng([seed, nb])
    owner = rng.integers(0, nb, n).astype(np.int32)
    owner[: n // 4] = rng.integers(0, min(nb, 2), n // 4)   # hot owners
    valid = rng.random(n) < 0.8
    return owner, valid


def _both(owner, valid):
    return ((jnp.asarray(owner), jnp.asarray(valid)),
            (torch.from_numpy(owner), torch.from_numpy(valid)))


@pytest.mark.parametrize("seed,nb,cap", PLAN_CASES)
def test_plan_buckets_dense(seed, nb, cap):
    j, t = _both(*_plan_inputs(seed, nb))
    _plans_eq(JC.plan_buckets_dense(*j, nb, cap),
              TC.plan_buckets_dense(*t, nb, cap))


@pytest.mark.parametrize("count_backend", ["jnp", "pallas"])
@pytest.mark.parametrize("seed,nb,cap", PLAN_CASES)
def test_plan_buckets_sorted(seed, nb, cap, count_backend):
    j, t = _both(*_plan_inputs(seed, nb))
    jp, jo = JC.plan_buckets_sorted(*j, nb, cap, count_backend=count_backend)
    tp, to = TC.plan_buckets_sorted(*t, nb, cap, count_backend=count_backend)
    _plans_eq(jp, tp)
    _eq(jo, to)
    _plans_eq(JC.plan_buckets_dense(*j, nb, cap), tp)


@pytest.mark.parametrize("seed,nb,cap", PLAN_CASES)
def test_plan_buckets_dispatch(seed, nb, cap):
    j, t = _both(*_plan_inputs(seed, nb))
    _plans_eq(JC.plan_buckets(*j, nb, cap), TC.plan_buckets(*t, nb, cap))


def test_count_backend_default_env_and_validation(monkeypatch):
    """The port defaults to the bucket-count kernel; ``REPRO_BUCKET_COUNT``
    and the keyword select as in the reference, other names raise."""
    _, (owner, valid) = _both(*_plan_inputs(3, 10))
    calls = []
    kernel = TC.bucket_count_kernel
    monkeypatch.setattr(TC, "bucket_count_kernel",
                        lambda o, nb: calls.append(nb) or kernel(o, nb))
    monkeypatch.delenv(TC.BUCKET_COUNT_ENV, raising=False)
    base, _ = TC.plan_buckets_sorted(owner, valid, 10, 8)
    assert calls == [10]
    monkeypatch.setenv(TC.BUCKET_COUNT_ENV, "jnp")
    env, _ = TC.plan_buckets_sorted(owner, valid, 10, 8)
    assert calls == [10]
    _plans_eq(base, env)
    TC.plan_buckets_sorted(owner, valid, 10, 8, count_backend="pallas")
    assert calls == [10, 10]
    monkeypatch.setenv(TC.BUCKET_COUNT_ENV, "nope")
    with pytest.raises(ValueError, match="count_backend"):
        TC.plan_buckets_sorted(owner, valid, 10, 8)
    with pytest.raises(ValueError, match="count_backend"):
        TC.plan_buckets_sorted(owner, valid, 10, 8, count_backend="xla")


@pytest.mark.parametrize("seed,nb,cap", [(0, 4, 8), (1, 40, 3), (2, 1, 1000),
                                         (3, 7, 1)])
def test_scatter_gather_tree_payloads(seed, nb, cap):
    owner, valid = _plan_inputs(seed, nb)
    n = owner.shape[0]
    j, t = _both(owner, valid)
    jp = JC.plan_buckets(*j, nb, cap)
    tp = to_bucket_plan(*(np.asarray(getattr(jp, f)) for f in FIELDS),
                        device="cpu")
    _plans_eq(tp, TC.plan_buckets(*t, nb, cap))
    rng = np.random.default_rng(seed)
    payload = {"t": rng.integers(0, 99, n).astype(np.int32),
               "v": rng.random((n, 2)).astype(np.float32),
               "b": rng.random(n) < 0.5}
    jpay = {k: jnp.asarray(a) for k, a in payload.items()}
    tpay = {k: torch.from_numpy(a) for k, a in payload.items()}
    for fill in (0, -1):
        jbuf = JC.scatter_to_buckets(jp, jpay, nb, cap, fill=fill)
        tbuf = TC.scatter_to_buckets(tp, tpay, nb, cap, fill=fill)
        assert sorted(tbuf) == sorted(jbuf)
        for k in jbuf:
            assert tuple(tbuf[k].shape) == jbuf[k].shape
            _eq(jbuf[k], tbuf[k])
        jback = JC.gather_from_buckets(jbuf, jp, cap, fill=fill)
        tback = TC.gather_from_buckets(tbuf, tp, cap, fill=fill)
        for k in jback:
            _eq(jback[k], tback[k])
    _eq(JC.bucket_message_ids(jp, nb, cap),
        TC.bucket_message_ids(tp, nb, cap))
    jt = JC.scatter_to_buckets(jp, (jpay["t"], jpay["v"]), nb, cap)
    tt = TC.scatter_to_buckets(tp, (tpay["t"], tpay["v"]), nb, cap)
    assert isinstance(tt, tuple)
    for a, b in zip(jt, tt):
        _eq(a, b)


# -- batch messages and batched commits --------------------------------------


@pytest.mark.parametrize("backend", ["coarse", "pallas", "fused"])
@pytest.mark.parametrize("op,dt", [("min", np.int32), ("add", np.float32)])
def test_lane_messages_commit_lanes(op, dt, backend):
    rng = np.random.default_rng(5)
    lanes, v, n = 3, 40, 120
    state = rng.integers(0, 100, (lanes, v)).astype(dt)
    tgt = rng.integers(0, v, (lanes, n)).astype(np.int32)
    val = (rng.integers(0, 100, (lanes, n)) / (8 if dt == np.float32 else 1)
           ).astype(dt)
    valid = rng.random((lanes, n)) < 0.7
    jm = JM.lane_messages(jnp.asarray(tgt), jnp.asarray(val),
                          jnp.asarray(valid), v)
    tm = TM.lane_messages(torch.from_numpy(tgt), torch.from_numpy(val),
                          torch.from_numpy(valid), v)
    for f in ("target", "payload", "valid"):
        _eq(getattr(jm, f), getattr(tm, f))
    jr = JCM.commit_lanes(jnp.asarray(state), jm, op,
                          JCM.CommitSpec(backend=backend))
    tr = TCM.commit_lanes(torch.from_numpy(state), tm, op,
                          TCM.CommitSpec(backend=backend))
    np.testing.assert_allclose(_np(tr.state), _np(jr.state), rtol=2e-4,
                               atol=1e-6)
    assert tr.state.shape == (lanes, v)
    _eq(jr.success, tr.success)


def test_product_and_graph_batch_commits():
    rng = np.random.default_rng(6)
    sizes, lanes, n = (5, 9, 4), 2, 80
    jax_ax, t_ax = JC.ProductAxis(lanes, sizes), TC.ProductAxis(lanes, sizes)
    vtot = t_ax.num_vertices
    state = rng.integers(0, 50, (lanes, vtot)).astype(np.int32)
    tgt = rng.integers(0, vtot, (lanes, n)).astype(np.int32)
    val = rng.integers(0, 50, (lanes, n)).astype(np.int32)
    valid = rng.random((lanes, n)) < 0.8
    jm = JM.product_messages(jnp.asarray(tgt), jnp.asarray(val),
                             jnp.asarray(valid), jax_ax)
    tm = TM.product_messages(torch.from_numpy(tgt), torch.from_numpy(val),
                             torch.from_numpy(valid), t_ax)
    _eq(jm.target, tm.target)
    jr = JCM.commit_product(jnp.asarray(state), jm, "min", axis=jax_ax)
    tr = TCM.commit_product(torch.from_numpy(state), tm, "min", axis=t_ax)
    _eq(jr.state, tr.state)
    _eq(jr.success, tr.success)
    with pytest.raises(ValueError, match="product axis"):
        TCM.commit_product(torch.from_numpy(state[:1]), tm, "min",
                           axis=t_ax)
    # graph batch: one query per graph, keys offset[g] + v
    gb_j, gb_t = JC.GraphBatch(sizes), TC.GraphBatch(sizes)
    g = rng.integers(0, len(sizes), n)
    v = (rng.random(n) * np.asarray(sizes)[g]).astype(np.int32)
    flat_state = rng.integers(0, 50, vtot).astype(np.int32)
    jm = JM.batch_messages(gb_j, jnp.asarray(g), jnp.asarray(v),
                           jnp.asarray(val[0]), jnp.asarray(valid[0]))
    tm = TM.batch_messages(gb_t, torch.from_numpy(g), torch.from_numpy(v),
                           torch.from_numpy(val[0]),
                           torch.from_numpy(valid[0]))
    _eq(jm.target, tm.target)
    jr = JCM.commit_batched(jnp.asarray(flat_state), jm, "min", axis=gb_j)
    tr = TCM.commit_batched(torch.from_numpy(flat_state), tm, "min",
                            axis=gb_t)
    _eq(jr.state, tr.state)
    with pytest.raises(ValueError, match="flat size"):
        TCM.commit_batched(torch.from_numpy(flat_state[:-1]), tm, "min",
                           axis=gb_t)


# -- the 1-D edge partition --------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("name", ["kron8", "grid"])
def test_partition_edges_identical(name, shards):
    g = (JG.kronecker(8, 8, seed=1) if name == "kron8"
         else JG.random_weights(JG.grid2d(9), seed=2))
    tg = to_graph(*(np.asarray(a) for a in (g.indptr, g.src, g.dst,
                                            g.weights)),
                  g.num_vertices, device="cpu")
    (ja, jpart), (ta, tpart) = (JCSR.partition_edges(g, shards),
                                TCSR.partition_edges(tg, shards))
    assert (jpart.num_shards, jpart.block) == (tpart.num_shards, tpart.block)
    for a, b in zip(ja, ta):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tpart.owner(tpart.block + 1) == 1 and tpart.local(5) == 5
