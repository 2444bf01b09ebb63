"""The port's kernels against the reference's Pallas kernels.

On the CPU the wrappers of ``repro_torch.kernels`` run their plain
versions; the reference kernels run in interpret mode, as in
``tests/test_kernels.py``.  Inputs come from one numpy seed and go to
both.  Tolerance: bit-identical state, conflict count and bucket counts,
float ``add`` within rtol 2e-4 / atol 1e-6 (the reference's
reassociation bound, ``repro/analysis/sanitize.py``).  The CUDA kernels
are held against the same plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.coarse_commit import coarse_commit_pallas
from repro.kernels.fused_wave import fused_route_commit_pallas
from repro_torch.kernels.coalesce import bucket_count_kernel
from repro_torch.kernels.coarse_commit import coarse_commit_kernel
from repro_torch.kernels.fused_wave import fused_route_commit_kernel

ADD_RTOL, ADD_ATOL = 2e-4, 1e-6
OP_TYPES = [("min", np.int32), ("max", np.int32), ("add", np.int32),
            ("min", np.float32), ("max", np.float32), ("add", np.float32),
            ("or", np.int32), ("first", np.int32)]
OP_IDS = [f"{op}-{np.dtype(dt).name}" for op, dt in OP_TYPES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each
    (a worker's default of one thread per core makes the port's small
    ops several times slower under the suite's load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(op, dt, v, n, rng):
    """(state, val): 'first' treats negative state as empty and takes
    non-negative payloads; 'or' payloads are truth values."""
    if op == "first":
        state = np.where(rng.random(v) < 0.5, -1, rng.integers(0, 50, v))
        val = rng.integers(0, 50, n)
    elif op == "or":
        state, val = rng.integers(0, 2, v), rng.integers(0, 2, n)
    else:
        state = rng.integers(-50, 50, v)
        val = rng.integers(-50, 50, n) / (7.0 if dt == np.float32 else 1)
    return state.astype(dt), val.astype(dt)


def _assert_state(op, dt, got, exp):
    if op == "add" and dt == np.float32:
        np.testing.assert_allclose(got, exp, rtol=ADD_RTOL, atol=ADD_ATOL)
    else:
        np.testing.assert_array_equal(got, exp)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _op_index(op, dt):
    return OP_IDS.index(f"{op}-{np.dtype(dt).name}")


@functools.lru_cache(maxsize=None)
def _coarse_case(op, dt, tile_m, block_v):
    """(inputs, state, conflicts) of the reference kernel, run once with
    stats=True for both stats cases of a test (its state does not depend
    on stats).  Targets run past V into the reference's block padding and
    beyond: padding targets count as conflicts but never commit."""
    rng = np.random.default_rng([tile_m, block_v, _op_index(op, dt)])
    v, n = 100, 300
    state, val = _inputs(op, dt, v, n, rng)
    idx = rng.integers(-1, v + 20, n).astype(np.int32)
    idx[:40] = rng.integers(0, 4, 40)              # dense duplicates
    exp, conf = coarse_commit_pallas(jnp.asarray(state), jnp.asarray(idx),
                                     jnp.asarray(val), op=op, tile_m=tile_m,
                                     block_v=block_v, stats=True)
    return (state, idx, val), np.asarray(exp), int(conf)


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("block_v", [16, 256])
@pytest.mark.parametrize("tile_m", [1, 7, 32, 128])
@pytest.mark.parametrize("op,dt", OP_TYPES, ids=OP_IDS)
def test_coarse_commit_matches_pallas(op, dt, tile_m, block_v, stats):
    (state, idx, val), exp, exp_c = _coarse_case(op, dt, tile_m, block_v)
    got = coarse_commit_kernel(_t(state), _t(idx), _t(val), op=op,
                               tile_m=tile_m, block_v=block_v, stats=stats)
    if stats:
        got, got_c = got
        assert int(got_c) == exp_c
        assert got_c.dtype == torch.int32
    _assert_state(op, dt, got.numpy(), exp)


_LAYOUTS = {            # (width, nrows, base): base/lane/width as in
    "plain": (1, 90, None),        # tests/test_fused_wave.py
    "base": (1, 50, 64),
    "lanes": (3, 40, 128),
}


@functools.lru_cache(maxsize=None)
def _fused_case(op, dt, layout, tile_m):
    """As :func:`_coarse_case`, for the fused kernel."""
    width, nrows, base = _LAYOUTS[layout]
    rng = np.random.default_rng([tile_m, len(layout), _op_index(op, dt)])
    n = 200
    state, val = _inputs(op, dt, nrows * width, n, rng)
    b0 = base or 0
    tgt = rng.integers(b0 - 5, b0 + nrows + 5, n).astype(np.int32)
    tgt[rng.random(n) < 0.15] = -1                 # bucket-fill sentinels
    lane = (rng.integers(-1, width + 1, n).astype(np.int32) if width > 1
            else None)
    exp, conf = fused_route_commit_pallas(
        jnp.asarray(state), jnp.asarray(tgt), jnp.asarray(val),
        lane=None if lane is None else jnp.asarray(lane), base=base,
        width=width, op=op, tile_m=tile_m, block_v=32, stats=True)
    return (state, tgt, val, lane), np.asarray(exp), int(conf)


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("tile_m", [1, 7, 32, 128])
@pytest.mark.parametrize("layout", list(_LAYOUTS))
@pytest.mark.parametrize("op,dt", OP_TYPES, ids=OP_IDS)
def test_fused_route_commit_matches_pallas(op, dt, layout, tile_m, stats):
    width, _, base = _LAYOUTS[layout]
    (state, tgt, val, lane), exp, exp_c = _fused_case(op, dt, layout, tile_m)
    got = fused_route_commit_kernel(
        _t(state), _t(tgt), _t(val), lane=None if lane is None else _t(lane),
        base=base, width=width, op=op, tile_m=tile_m, stats=stats)
    if stats:
        got, got_c = got
        assert int(got_c) == exp_c
    _assert_state(op, dt, got.numpy(), exp)


def test_coarse_commit_stats_output():
    """The reference's pinned counts: 5 conflicts in one transaction of
    8, 4 in two transactions of 4 (the pair on vertex 3 splits 2|1)."""
    state = torch.zeros(16, dtype=torch.int32)
    idx = torch.tensor([1, 1, 2, 3, 3, 3, -1, -1], dtype=torch.int32)
    val = torch.ones(8, dtype=torch.int32)
    out, conf = coarse_commit_kernel(state, idx, val, op="add", tile_m=8,
                                     block_v=16, stats=True)
    assert int(conf) == 5
    np.testing.assert_array_equal(
        out.numpy(), [0, 2, 1, 3] + [0] * 12)
    _, conf2 = coarse_commit_kernel(state, idx, val, op="add", tile_m=4,
                                    block_v=16, stats=True)
    assert int(conf2) == 4


def test_fused_base_as_tensor_matches_int():
    rng = np.random.default_rng(3)
    state = torch.full((30,), 1000, dtype=torch.int32)
    tgt = _t(rng.integers(60, 95, 50).astype(np.int32))
    val = _t(rng.integers(0, 50, 50).astype(np.int32))
    a = fused_route_commit_kernel(state, tgt, val, base=64, op="min")
    b = fused_route_commit_kernel(state, tgt, val, op="min",
                                  base=torch.tensor(64, dtype=torch.int32))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrappers_reject_bad_arguments():
    st = torch.zeros(8, dtype=torch.int32)
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="op"):
        coarse_commit_kernel(st, t, t, op="xor")
    with pytest.raises(ValueError, match="tile_m"):
        coarse_commit_kernel(st, t, t, tile_m=0)
    with pytest.raises(ValueError, match="lane ids"):
        fused_route_commit_kernel(st, t, t, width=2, op="add")
    with pytest.raises(ValueError, match="lane ids"):
        fused_route_commit_kernel(st, t, t, lane=t, width=1, op="add")
    with pytest.raises(ValueError, match="divisible"):
        fused_route_commit_kernel(st, t, t, lane=t, width=3, op="add")


def test_empty_batch_returns_state():
    st = torch.arange(5, dtype=torch.int32)
    e = torch.zeros(0, dtype=torch.int32)
    out, conf = coarse_commit_kernel(st, e, e, stats=True)
    assert torch.equal(out, st) and int(conf) == 0
    out, conf = fused_route_commit_kernel(st, e, e, stats=True)
    assert torch.equal(out, st) and int(conf) == 0


@pytest.mark.parametrize("n", [0, 1, 1000, 5000])
@pytest.mark.parametrize("nb", [1, 7, 128, 300])
def test_bucket_count_matches_pallas(nb, n):
    """Ids run from -2 to nb + 2: ``-1``, other negatives and ids
    ``>= nb`` are all masked.  The reference's Pallas kernel fails at
    N = 0 (its first tile is longer than the input), so that case is
    held to the reference's ``bucket_count_ref`` alone."""
    rng = np.random.default_rng([nb, n])
    owner = rng.integers(-2, nb + 3, n).astype(np.int32)
    owner[: n // 3] = rng.integers(0, min(nb, 3), n // 3)    # hot buckets
    got = bucket_count_kernel(_t(owner), nb)
    assert got.dtype == torch.int32 and got.shape == (nb,)
    exp = np.asarray(jref.bucket_count_ref(jnp.asarray(owner), nb))
    np.testing.assert_array_equal(got.numpy(), exp)
    if n:
        exp_pallas = jops.bucket_count(jnp.asarray(owner), num_buckets=nb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp_pallas))


def test_bucket_count_rejects_bad_arguments():
    with pytest.raises(ValueError, match="num_buckets"):
        bucket_count_kernel(torch.zeros(4, dtype=torch.int32), 0)
