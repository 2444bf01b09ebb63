"""The port's conflict sanitizer (``repro_torch.analysis.sanitize``)
against the reference package on the CPU.

* ``_perm`` equals the reference's permutation for every capacity.
* The rank-aware ``first`` shadow equals the reference's on the same
  batch (ties included).
* ``CommitSpec(sanitize=True)`` is clean over backends x ops, ``first``
  with ties included, and on bool ``or`` state; ``REPRO_SANITIZE=1`` turns
  it on without touching specs; a planted order-dependent result raises
  ``SanitizeError`` and records a report, as in the reference's
  ``test_sanitize_catches_order_dependence``; ``sanitize`` rides the
  tuner's per-level specs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import sanitize as JSan
from repro.core.messages import make_messages as jmake
from repro_torch.analysis import sanitize as TSan
from repro_torch.core import autotune as TAT
from repro_torch.core.commit import CommitSpec, commit
from repro_torch.core.messages import make_messages

BACKENDS = ("atomic", "coarse", "pallas", "fused", "auto")


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
def _clean(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "off")
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    TSan.clear_reports()
    yield
    TSan.clear_reports()


@pytest.mark.parametrize("n", [0, 1, 2, 7, 128, 1000, 65537])
def test_perm_matches_reference(n):
    np.testing.assert_array_equal(TSan._perm(n), JSan._perm(n))
    assert TSan._perm(n).dtype == np.int32
    assert (TSan.ADD_RTOL, TSan.ADD_ATOL) == (JSan.ADD_RTOL, JSan.ADD_ATOL)


def _first_batch(seed, v=24, n=96):
    rng = np.random.default_rng(seed)
    state = np.where(rng.random(v) < 0.5, -1, 7).astype(np.int32)
    tgt = rng.integers(0, v // 3, n).astype(np.int32)     # many ties
    pay = rng.integers(0, 50, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    return state, tgt, pay, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_shadow_matches_reference(seed):
    state, tgt, pay, valid = _first_batch(seed)
    n = tgt.shape[0]
    exp = JSan._first_shadow(jnp.asarray(state),
                             jmake(jnp.asarray(tgt), jnp.asarray(pay),
                                   jnp.asarray(valid)),
                             jnp.asarray(JSan._perm(n)))
    got = TSan._first_shadow(torch.from_numpy(state),
                             make_messages(torch.from_numpy(tgt),
                                           torch.from_numpy(pay),
                                           torch.from_numpy(valid)),
                             torch.from_numpy(TSan._perm(n)).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def _init_state(op, v, dtype):
    if op == "first":
        return torch.full((v,), -1, dtype=dtype)
    if op in ("add", "or"):
        return torch.zeros((v,), dtype=dtype)
    big = 1000
    return torch.full((v,), big if op == "min" else -big, dtype=dtype)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op,dtype", [(op, torch.int32) for op in
                                      ("min", "max", "add", "or", "first")]
                         + [("add", torch.float32), ("min", torch.float32)])
def test_sanitize_spec_clean(backend, op, dtype):
    rng = np.random.default_rng(3)
    v, n = 32, 128
    tgt = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
    pay = torch.from_numpy(rng.integers(0, 100, n).astype(np.int32))
    if op == "or":
        pay = pay % 2
    if dtype == torch.float32:
        pay = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    spec = CommitSpec(backend=backend, sanitize=True, tile_m=16)
    res = commit(_init_state(op, v, dtype), make_messages(tgt, pay), op,
                 spec)
    assert res.state.shape == (v,) and TSan.reports() == ()


def test_sanitize_first_with_ties_over_backends():
    state, tgt, pay, valid = _first_batch(4)
    msgs = make_messages(torch.from_numpy(tgt), torch.from_numpy(pay),
                         torch.from_numpy(valid))
    states = [commit(torch.from_numpy(state), msgs, "first",
                     CommitSpec(backend=b, sanitize=True)).state
              for b in BACKENDS]
    for s in states[1:]:
        assert torch.equal(s, states[0])
    assert TSan.reports() == ()


def test_sanitize_bool_state_or_wave():
    rng = np.random.default_rng(6)
    v, n = 16, 64
    tgt = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
    pay = torch.from_numpy(rng.random(n) < 0.5)
    res = commit(torch.zeros(v, dtype=torch.bool), make_messages(tgt, pay),
                 "or", CommitSpec(backend="coarse", sanitize=True))
    assert res.state.dtype == torch.bool and TSan.reports() == ()


def test_sanitize_env_var(monkeypatch):
    """``REPRO_SANITIZE=1`` shadows every commit: a replay that differs
    raises, though the spec does not ask for the shadow."""
    rng = np.random.default_rng(4)
    v, n = 16, 64
    tgt = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
    pay = torch.from_numpy((rng.standard_normal(n) / 3).astype(np.float32))
    msgs = make_messages(tgt, pay)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    commit(torch.zeros(v), msgs, "add", CommitSpec(backend="coarse"))
    assert TSan.reports() == ()
    calls = []
    real = TSan.shadow_check

    def spy(*args):
        calls.append(args[4])
        return real(*args)
    monkeypatch.setattr(TSan, "shadow_check", spy)
    commit(torch.zeros(v), msgs, "add", CommitSpec(backend="atomic"))
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    commit(torch.zeros(v), msgs, "add", CommitSpec(backend="atomic"))
    assert calls == ["atomic"]


def test_sanitize_catches_order_dependence():
    rng = np.random.default_rng(5)
    v, n = 16, 64
    tgt = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
    pay = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    st0 = torch.zeros(v)
    with pytest.raises(TSan.SanitizeError, match="order-dependent"):
        TSan.shadow_check(st0, make_messages(tgt, pay), "add",
                          CommitSpec(backend="atomic"), "atomic", st0 + 1.0)
    (rep,) = TSan.reports()
    assert (rep.op, rep.backend, rep.capacity) == ("add", "atomic", n)
    assert rep.max_abs_err > 0.5
    state, tgt, pay, valid = _first_batch(2)
    wrong = torch.from_numpy(state).clone()
    wrong[0] = 99
    with pytest.raises(TSan.SanitizeError):
        TSan.shadow_check(torch.from_numpy(state),
                          make_messages(torch.from_numpy(tgt),
                                        torch.from_numpy(pay),
                                        torch.from_numpy(valid)),
                          "first", CommitSpec(backend="coarse"), "coarse",
                          wrong)
    assert len(TSan.reports()) == 2


def test_sanitize_rides_tuner_policy():
    pol = TAT.TunerPolicy(backend="coarse", sanitize=True)
    assert all(pol.spec_at(i).sanitize for i in range(len(pol.ladder)))
    assert TAT.TunerPolicy(backend="coarse").spec_at(0).sanitize is False
    pol = TAT.policy_for(CommitSpec(backend="auto", sanitize=True),
                         torch.zeros(64, dtype=torch.int32), n=100)
    assert pol.sanitize is True
