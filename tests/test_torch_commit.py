"""The port's ``commit()`` against ``repro.core.commit.commit``.

Each case runs one backend of both packages on the same numpy inputs and
compares the whole ``CommitResult``: state, success, conflicts and
applied.  The batches replay the parity matrices of
``tests/test_commit.py``.  Bit-identical except float ``add`` (rtol 2e-4,
atol 1e-6, the reference's reassociation bound).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import commit as JC
from repro.core.messages import make_messages as j_messages
from repro_torch.convert import to_messages, to_state
from repro_torch.core import commit as TC
from repro_torch.core.autotune import make_commit_step
from repro_torch.core.messages import (FF_MF, Messages, concat_messages,
                                       make_messages)

V_PAR = 61
FIELDS = ("state", "success", "conflicts", "applied")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each
    (a worker's default of one thread per core makes the port's small
    ops several times slower under the suite's load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init_state(op, rng):
    if op == "min":
        return np.full(V_PAR, 1000, np.int32)
    if op == "max":
        return np.full(V_PAR, -1000, np.int32)
    if op == "first":
        return np.where(rng.random(V_PAR) < 0.5, -1, 777).astype(np.int32)
    return np.zeros(V_PAR, np.int32)


def _parity_batches(op, rng):
    n = 120
    lo = 0 if op == "first" else (-2 if op == "or" else -50)
    hi = 2 if op == "or" else 50
    yield ("random", rng.integers(0, V_PAR, n),
           rng.integers(lo, hi, n), rng.random(n) < 0.8)
    yield ("duplicate_target", np.full(n, 7),
           rng.integers(lo, hi, n), np.ones(n, bool))
    yield ("all_invalid", rng.integers(0, V_PAR, n),
           rng.integers(lo, hi, n), np.zeros(n, bool))
    yield ("empty_batch", np.zeros(0, np.int64), np.zeros(0, np.int64),
           np.zeros(0, bool))


def _both(state, tgt, val, valid, op, **spec):
    jr = JC.commit(jnp.asarray(state),
                   j_messages(jnp.asarray(tgt, jnp.int32), jnp.asarray(val),
                              jnp.asarray(valid)),
                   op, JC.CommitSpec(**spec))
    tr = TC.commit(to_state(state, device="cpu"),
                   to_messages(tgt, val, valid, device="cpu"), op,
                   TC.CommitSpec(**spec))
    return jr, tr


def _assert_result(jr, tr, msg, float_add=False):
    for field in FIELDS:
        exp = np.asarray(getattr(jr, field))
        got = getattr(tr, field).numpy()
        if field == "state" and float_add:
            np.testing.assert_allclose(got, exp, rtol=2e-4, atol=1e-6,
                                       err_msg=f"{msg}/{field}")
        else:
            np.testing.assert_array_equal(got, exp, err_msg=f"{msg}/{field}")


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("backend", TC.BACKENDS)
@pytest.mark.parametrize("op", TC.OPS)
def test_parity_matrix(op, backend, stats):
    """Whole-batch transactions (m=None, kernel tile 32)."""
    rng = np.random.default_rng(sum(map(ord, op)))
    for name, tgt, val, valid in _parity_batches(op, rng):
        state = _init_state(op, rng)
        jr, tr = _both(state, tgt, val.astype(np.int32), valid, op,
                       backend=backend, m=None, tile_m=32, stats=stats)
        _assert_result(jr, tr, f"{op}/{backend}/{name}")


@pytest.mark.parametrize("m", [1, 7, 32])
@pytest.mark.parametrize("op", TC.OPS)
def test_parity_matrix_tiled(op, m):
    rng = np.random.default_rng(17 + m)
    for name, tgt, val, valid in _parity_batches(op, rng):
        state = _init_state(op, rng)
        for backend in TC.BACKENDS:
            jr, tr = _both(state, tgt, val.astype(np.int32), valid, op,
                           backend=backend, m=m)
            _assert_result(jr, tr, f"{op}/{backend}/{name}/m={m}")


@pytest.mark.parametrize("backend", TC.BACKENDS)
def test_float_min_and_add(backend):
    rng = np.random.default_rng(5)
    tgt = rng.integers(0, 96, 300)
    val = (rng.integers(0, 50, 300) / 7.0).astype(np.float32)
    valid = rng.random(300) < 0.8
    for op, state in (("min", np.full(96, 1e9, np.float32)),
                      ("add", np.zeros(96, np.float32))):
        for m in (None, 32):
            jr, tr = _both(state, tgt, val, valid, op, backend=backend, m=m,
                           tile_m=64)
            _assert_result(jr, tr, f"{op}/{backend}/m={m}",
                           float_add=op == "add")


def _site_inputs(seed, width, nrows, base, n):
    rng = np.random.default_rng(seed)
    tgt = rng.integers(base - 5, base + nrows + 5, n).astype(np.int32)
    tgt[rng.random(n) < 0.15] = -1
    lane = rng.integers(0, width, n).astype(np.int32)
    val = rng.integers(0, 50, n).astype(np.int32)
    return tgt, lane, val


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("op", ["min", "add", "first"])
def test_fused_commit_site_parity(op, stats):
    width, nrows, base, n = 3, 40, 128, 90
    tgt, lane, val = _site_inputs(11, width, nrows, base, n)
    if op == "first":
        state = np.full(nrows * width, -1, np.int32)
    elif op == "add":
        state = np.zeros(nrows * width, np.int32)
    else:
        state = np.full(nrows * width, 1 << 30, np.int32)
    jr = JC.fused_commit_site(
        jnp.asarray(state), jnp.asarray(tgt), jnp.asarray(val), op,
        JC.CommitSpec(backend="fused", stats=stats, tile_m=32, block_v=64,
                      interpret=True),
        lane=jnp.asarray(lane), base=base, width=width)
    tr = TC.fused_commit_site(
        torch.from_numpy(state), torch.from_numpy(tgt),
        torch.from_numpy(val), op,
        TC.CommitSpec(backend="fused", stats=stats, tile_m=32),
        lane=torch.from_numpy(lane), base=base, width=width)
    _assert_result(jr, tr, f"site/{op}")


def test_fused_commit_site_base_only():
    nrows, base, n = 50, 64, 70
    tgt, _, val = _site_inputs(12, 1, nrows, base, n)
    state = np.full(nrows, 1 << 30, np.int32)
    jr = JC.fused_commit_site(
        jnp.asarray(state), jnp.asarray(tgt), jnp.asarray(val), "min",
        JC.CommitSpec(backend="fused", stats=True, interpret=True),
        base=base)
    tr = TC.fused_commit_site(
        torch.from_numpy(state), torch.from_numpy(tgt),
        torch.from_numpy(val), "min", TC.CommitSpec(backend="fused"),
        base=base)
    _assert_result(jr, tr, "site/base")


def test_fused_site_supported_matches_reference():
    cases = [((8,), np.int32, (4,), np.int32), ((8,), np.int32, (2, 3),
                                                 np.float32),
             ((8,), np.int32, (4,), bool), ((8,), np.int32, (2, 2, 2),
                                            np.int32),
             ((4, 2), np.int32, (4,), np.int32)]
    for sshape, sdt, pshape, pdt in cases:
        s, p = np.zeros(sshape, sdt), np.zeros(pshape, pdt)
        assert TC.fused_site_supported(torch.from_numpy(s),
                                       torch.from_numpy(p)) == \
            JC.fused_site_supported(jnp.asarray(s), jnp.asarray(p))


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_kernel_tiers_fall_back_for_unsupported_dtypes(backend):
    """A bool state takes the coarse path on both kernel tiers."""
    jr, tr = _both(np.zeros(4, bool), np.array([0, 1]),
                   np.array([True, False]), np.ones(2, bool), "or",
                   backend=backend)
    _assert_result(jr, tr, backend)
    np.testing.assert_array_equal(tr.state.numpy(), [1, 0, 0, 0])


def test_commit_rejects_unknown_op_and_backend():
    msgs = make_messages(torch.tensor([0]),
                         torch.tensor([1], dtype=torch.int32))
    state = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        TC.commit(state, msgs, "xor")
    with pytest.raises(ValueError):
        TC.commit(state, msgs, "min", TC.CommitSpec(backend="cuda"))
    with pytest.raises(ValueError):
        TC.CommitSpec(m=0)


def test_commit_step_is_static_passthrough():
    state = torch.full((8,), 100, dtype=torch.int32)
    msgs = make_messages(torch.tensor([3, 3, 5]),
                         torch.tensor([7, 9, 1], dtype=torch.int32))
    step, lvl0 = make_commit_step(TC.CommitSpec(backend="pallas"), "min",
                                  state)
    res, lvl = step(state, msgs, lvl0)
    assert lvl is lvl0 and int(lvl0) == 0
    assert res.state.tolist() == [100, 100, 100, 7, 100, 1, 100, 100]
    assert res.success.tolist() == [True, False, True]


def test_messages_helpers():
    a = make_messages(torch.tensor([1, 2]), torch.tensor([5.0, 6.0]))
    b = make_messages(torch.tensor([3]), torch.tensor([7.0]),
                      torch.tensor([False]))
    c = concat_messages(a, b)
    assert isinstance(c, Messages) and c.capacity == 3
    assert c.target.dtype == torch.int32 and int(c.count()) == 2
    assert FF_MF.tag == "FF&MF"


# vector payloads: [n, d] messages into a [V, d] state, the cases the
# reference's tiers run (add at any stats; min/max at stats=False; or at
# stats=False on the unsorted path)
VECTOR_CASES = [("add", True, np.float32), ("add", False, np.float32),
                ("add", True, np.int32), ("min", False, np.int32),
                ("max", False, np.float32)]


def _vector_batch(op, dtype, seed, v=13, n=90, d=3):
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, v, n)
    val = rng.integers(-20, 20, (n, d)).astype(dtype)
    if dtype == np.float32:
        val = val / np.float32(7)
    valid = rng.random(n) < 0.8
    fill = {"min": 5, "max": -5}.get(op, 0)
    state = np.full((v, d), fill, dtype)
    state[rng.random(v) < 0.3] = 0
    return state, tgt, val, valid


@pytest.mark.parametrize("m", [None, 7])
@pytest.mark.parametrize("backend", TC.BACKENDS)
@pytest.mark.parametrize("op,stats,dtype", VECTOR_CASES)
def test_vector_payload_parity(op, stats, dtype, backend, m):
    """State and telemetry equal the reference's; ``pallas`` and ``fused``
    run ``coarse``, as the reference's ``commit()`` sends them."""
    state, tgt, val, valid = _vector_batch(op, dtype, seed=len(op) + 3)
    spec = dict(m=m, stats=stats)
    jr, tr = _both(state, tgt, val, valid, op, backend=backend, **spec)
    _assert_result(jr, tr, f"{op}/{backend}/m={m}",
                   float_add=op == "add" and dtype == np.float32)
    if backend in ("pallas", "fused"):
        cr = TC.commit(to_state(state, device="cpu"),
                       to_messages(tgt, val, valid, device="cpu"), op,
                       TC.CommitSpec(backend="coarse", **spec))
        for field in FIELDS:
            assert torch.equal(getattr(tr, field), getattr(cr, field))


@pytest.mark.parametrize("sort", [True, False])
def test_vector_applied_counts_rows_changed_in_any_component(sort):
    """``coarse`` at stats=False: a message whose row changed in one
    component counts once; ``or`` runs unsorted only, as in the
    reference."""
    state = np.zeros((4, 3), np.int32)
    tgt, valid = np.array([0, 0, 2, 3]), np.ones(4, bool)
    val = np.array([[0, 1, 0], [0, 0, 0], [2, 2, 2], [0, 0, 0]], np.int32)
    if sort:
        jr, tr = _both(state, tgt, val, valid, "max", backend="coarse",
                       stats=False)
        _assert_result(jr, tr, "max")
        assert int(tr.applied) == 2 and int(tr.conflicts) == 1
    else:
        jr, tr = _both(state, tgt, val, valid, "or", backend="coarse",
                       sort=False, stats=False)
        _assert_result(jr, tr, "or")
        np.testing.assert_array_equal(tr.state.numpy()[[0, 2]],
                                      [[0, 1, 0], [1, 1, 1]])


@pytest.mark.parametrize("op,stats,backend", [
    ("min", True, "coarse"), ("max", True, "atomic"), ("or", False, "coarse"),
    ("first", False, "atomic"), ("first", True, "pallas")])
def test_vector_payload_rejects_what_the_reference_cannot_run(op, stats,
                                                              backend):
    state, tgt, val, valid = _vector_batch("add", np.int32, seed=1)
    if op == "first":
        state[:] = -1
    with pytest.raises(ValueError):
        JC.commit(jnp.asarray(state),
                  j_messages(jnp.asarray(tgt, jnp.int32), jnp.asarray(val),
                             jnp.asarray(valid)), op,
                  JC.CommitSpec(backend=backend, stats=stats))
    with pytest.raises(ValueError, match="vector payloads"):
        TC.commit(to_state(state, device="cpu"),
                  to_messages(tgt, val, valid, device="cpu"), op,
                  TC.CommitSpec(backend=backend, stats=stats))
