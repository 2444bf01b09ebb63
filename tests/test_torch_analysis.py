"""The port's static analysis (``repro_torch.analysis``) against the
reference's, on the CPU.

* **Algebra**: the port's ``ALGEBRA`` equals the reference's field by
  field; every check is clean in both; a bad declaration gives the same
  findings in both, up to the package name; the source census finds the
  same commit ops in each algorithm module; a lost replay guard is found.
* **Key space**: every ``KeyspaceReport`` field equals the reference's on
  the reference CLI's six default axes, a colliding duck-typed axis and
  an overflowing product axis.
* **Race pass**: the capture catalog has the reference's 18 labels and
  algorithm names; the shipped port is clean on all four tiers with a
  commit in every entry; planted rounds get the verdicts of the
  reference's own tests (``tests/test_analysis.py``): a raw scatter into
  state and an unscoped kernel op are flagged, the commit route is
  accepted, a loop of rounds is seen through.  The reference's race pass
  itself cannot run on this JAX (``jax.core.Literal`` is gone), so the
  port is held to that contract.
* **CLI**: ``python -m repro_torch.analysis.lint --device cpu
  --trace-off-clean`` exits 0; planted modules (written to ``tmp_path``)
  exit 1 with their findings; ``--bench-schema`` finds what the
  reference's ``run_bench_schema`` finds.
* **Recorder**: a kernel launch is one ``repro_torch::*`` record; keys
  follow storages, not addresses; ``commit_scope`` counts entries.
"""
import dataclasses
import json
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import algebra as j_algebra
from repro.analysis import keyspace as j_keyspace
from repro.analysis import lint as j_lint
from repro.analysis import waverace as j_waverace
from repro_torch.analysis import algebra, keyspace, lint, waverace
from repro_torch.analysis.optrace import OpRecorder, record
from repro_torch.core.commit import (BACKENDS, CommitSpec, commit,
                                     commit_scope)
from repro_torch.core.messages import make_messages
from repro_torch.kernels.coalesce import bucket_count_kernel
from repro_torch.kernels.coarse_commit import coarse_commit_kernel
from repro_torch.kernels.fused_wave import fused_route_commit_kernel
from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread
    each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unpackage(findings):
    return [f.replace("repro_torch.", "repro.") for f in findings]


# -- algebra ----------------------------------------------------------------

def test_algebra_registry_equals_reference():
    assert set(algebra.ALGEBRA) == set(j_algebra.ALGEBRA)
    for op, decl in algebra.ALGEBRA.items():
        assert dataclasses.asdict(decl) == \
            dataclasses.asdict(j_algebra.ALGEBRA[op]), op


def test_algebra_checks_clean_in_both():
    for mod in (algebra, j_algebra):
        assert mod.check_algebra() == []
        assert mod.check_fused_order_dependence() == []
        assert mod.check_replay_paths() == []


def test_bad_declaration_gives_the_reference_findings(monkeypatch):
    for mod in (algebra, j_algebra):
        bad = dict(mod.ALGEBRA)
        bad["add"] = dataclasses.replace(mod.ALGEBRA["add"], idempotent=True)
        bad["min"] = dataclasses.replace(mod.ALGEBRA["min"],
                                         commutative=False)
        monkeypatch.setattr(mod, "ALGEBRA", bad)
    got, exp = algebra.check_algebra(), j_algebra.check_algebra()
    assert got and _unpackage(got) == exp
    assert any("'add'" in f and "idempotent" in f for f in got)


@pytest.mark.parametrize("i", range(6))
def test_ops_census_matches_reference(i):
    mod = algebra.ALGO_MODULES[i]
    ref = j_algebra.ALGO_MODULES[i]
    assert mod == ref.replace("repro.", "repro_torch.")
    assert algebra.ops_in_module(mod) == j_algebra.ops_in_module(ref)


def test_replay_guard_loss_is_detected(monkeypatch):
    from repro_torch.serve import durable
    broken = tuple(
        dataclasses.replace(s, witness="THIS STRING IS NOT IN THE SOURCE")
        if s.name == "wal-replay" else s for s in durable.REPLAY_GUARDS)
    monkeypatch.setattr(durable, "REPLAY_GUARDS", broken)
    found = algebra.check_replay_paths()
    assert len(found) == 1 and "wal-replay" in found[0] and "add" in found[0]


# -- key space --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _BrokenLanes:
    """Stride V - 1 instead of V: lane k overlaps lane k + 1."""
    lanes: int
    num_vertices: int

    def flatten(self, major, minor):
        return np.asarray(major) * (self.num_vertices - 1) + np.asarray(minor)


@dataclasses.dataclass(frozen=True)
class _Unchecked:
    lanes: int
    sizes: tuple


def _axis_pairs():
    port = lint._default_axes()
    ref = j_lint._default_axes()
    pairs = [(p[1], r[1]) for p, r in zip(port, ref)]
    assert [p[0] for p in port] == [r[0] for r in ref]
    return pairs + [(_BrokenLanes(4, 10), _BrokenLanes(4, 10)),
                    (_Unchecked(4096, (10 ** 6,) * 600),) * 2]


@pytest.mark.parametrize("i", range(8))
def test_keyspace_reports_equal_reference(i):
    axis, j_axis = _axis_pairs()[i]
    got = keyspace.analyze_axis(axis, name=f"axis {i}")
    exp = j_keyspace.analyze_axis(j_axis, name=f"axis {i}")
    assert dataclasses.asdict(got) == dataclasses.asdict(exp)
    assert got.ok == exp.ok


# -- race pass --------------------------------------------------------------

def test_catalog_matches_reference():
    got = [(label, cap.alg.name)
           for label, cap in waverace.capture_algorithms(device="cpu")]
    exp = [(label, cap.alg.name)
           for label, cap in j_waverace.capture_algorithms()]
    assert len(got) == 18 and got == exp


@pytest.mark.parametrize("backend", BACKENDS)
def test_shipped_port_is_clean(backend):
    reps = waverace.check_all(spec=CommitSpec(backend=backend, stats=False),
                              device="cpu")
    assert len(reps) == 22
    for rep in reps:
        assert rep.ok, (rep.name, rep.findings)
        assert rep.commits >= 1, rep.name
        assert rep.reads >= 1, rep.name
        # on the CPU the kernel tiers run their ops' plain versions: one
        # scoped op per commit all the same
        assert rep.kernel_commits == (rep.commits if backend in
                                      ("pallas", "fused") else 0), rep.name


_V = 16


def _state():
    return {"dist": torch.zeros((_V,), dtype=torch.int32)}


def _edges():
    src = torch.arange(_V)
    return src, (src * 5 + 3) % _V


def test_race_detector_fires_on_raw_scatter():
    src, dst = _edges()

    def racy(state):
        d = state["dist"]
        return {"dist": d.scatter_reduce_(0, dst, d[src] + 1, "amin")}

    rep = waverace.check_traceable("racy", racy, _state())
    assert not rep.ok and rep.findings[0].op == "aten::scatter_reduce_"
    assert rep.reads == 1


def test_race_detector_fires_on_derived_state_write():
    """A write into a copy of state (a view, a clone, an arithmetic
    result) writes round state too."""
    src, dst = _edges()

    def racy(state):
        d = (state["dist"] + 0)[:]
        d.index_put_((dst,), d[src] + 1, accumulate=True)
        return {"dist": d}

    rep = waverace.check_traceable("racy-derived", racy, _state())
    assert [f.op for f in rep.findings] == ["aten::index_put_"]


def test_race_detector_accepts_commit_route():
    src, dst = _edges()

    def clean(state):
        d = state["dist"]
        res = commit(d, make_messages(dst, d[src] + 1), "min",
                     CommitSpec(backend="atomic", stats=False))
        return {"dist": res.state}

    rep = waverace.check_traceable("clean", clean, _state())
    assert rep.ok and rep.commits == 1


def test_race_detector_sees_through_loop_of_rounds():
    src, dst = _edges()

    def racy_loop(state):
        d = state["x"]
        for _ in range(3):
            d = d.index_add(0, dst, d[src])
        return {"x": d}

    rep = waverace.check_traceable(
        "racy-loop", racy_loop, {"x": torch.zeros((_V,), dtype=torch.int32)})
    assert len(rep.findings) == 3 and rep.reads == 3


def test_race_detector_flags_unscoped_kernel_op():
    src, dst = _edges()

    def unscoped(state):
        d = state["dist"]
        return {"dist": fused_route_commit_kernel(
            d, dst.to(torch.int32), d[src] + 1, op="min")}

    rep = waverace.check_traceable("unscoped", unscoped, _state())
    assert [f.op for f in rep.findings] == ["repro_torch::fused_route_commit"]

    def scoped(state):
        d = state["dist"]
        with commit_scope():
            return {"dist": fused_route_commit_kernel(
                d, dst.to(torch.int32), d[src] + 1, op="min")}

    rep = waverace.check_traceable("scoped", scoped, _state())
    assert rep.ok and rep.commits == 1 and rep.kernel_commits == 1


def test_check_refuses_auto():
    with pytest.raises(ValueError, match="static"):
        waverace.check_all(spec=CommitSpec(backend="auto"), device="cpu")


# -- CLI --------------------------------------------------------------------

PLANTED_RACE = '''
"""Planted violations: a raw scatter into round state and an unscoped
launch of the fused route+commit kernel op."""
import torch

from repro_torch.kernels.fused_wave import fused_route_commit_kernel

_V = 16
_SRC = torch.arange(_V)
_DST = (torch.arange(_V, dtype=torch.int32) * 5 + 3) % _V


def _racy_round(state):
    dist = state["dist"]
    relax = dist[_SRC] + 1
    return {"dist": dist.scatter_reduce_(0, _DST.long(), relax, "amin")}


def _unscoped_kernel_round(state):
    dist = state["dist"]
    relax = dist[_SRC] + 1
    return {"dist": fused_route_commit_kernel(dist, _DST, relax, op="min")}


LINT_TRACEABLES = (
    ("planted: racy bfs round", _racy_round,
     {"dist": torch.zeros((_V,), dtype=torch.int32)}),
    ("planted: unscoped fused-kernel commit", _unscoped_kernel_round,
     {"dist": torch.zeros((_V,), dtype=torch.int32)}),
)
'''

PLANTED_OVERFLOW = '''
import dataclasses


@dataclasses.dataclass(frozen=True)
class UncheckedProductAxis:
    lanes: int
    sizes: tuple


LINT_AXES = (
    ("planted: ProductAxis(4096, 600 x 1M)",
     UncheckedProductAxis(lanes=4096, sizes=(10 ** 6,) * 600)),
)
'''


def _plant(tmp_path, monkeypatch, name, source):
    (tmp_path / f"{name}.py").write_text(textwrap.dedent(source))
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, name, raising=False)
    return name


def test_cli_clean_on_shipped_port(capsys):
    assert lint.main(["--device", "cpu", "--trace-off-clean"]) == 0
    out = capsys.readouterr().out
    assert "aamlint: clean" in out
    assert out.count("  waverace ") == 22
    assert "trace-off control" in out


def test_cli_catches_planted_race(tmp_path, monkeypatch, capsys):
    mod = _plant(tmp_path, monkeypatch, "planted_race_port", PLANTED_RACE)
    assert lint.main(["--device", "cpu", "--skip-waverace",
                      "--module", mod]) == 1
    found = [line for line in capsys.readouterr().out.splitlines()
             if "FINDING" in line]
    assert len(found) == 2
    assert "raw aten::scatter_reduce_" in found[0]
    assert "kernel launch (repro_torch::fused_route_commit)" in found[1]


def test_cli_catches_planted_overflow(tmp_path, monkeypatch, capsys):
    mod = _plant(tmp_path, monkeypatch, "planted_overflow_port",
                 PLANTED_OVERFLOW)
    assert lint.main(["--device", "cpu", "--skip-waverace",
                      "--module", mod]) == 1
    found = [line for line in capsys.readouterr().out.splitlines()
             if "FINDING" in line]
    assert len(found) == 1 and "int32 key space" in found[0]


def test_cli_bench_schema_matches_reference(tmp_path, monkeypatch):
    good = {"schema": "aam-bench/v1", "sizes": {}, "platform": "cpu",
            "summary": {}, "rows": [{"suite": "s", "backend": "b",
                                     "name": "n", "us_per_call": 1.5,
                                     "derived": {}}]}
    bad = {"schema": "v0", "rows": [{"suite": "s", "us_per_call": "x"}]}
    (tmp_path / "BENCH_a.json").write_text(json.dumps(good))
    (tmp_path / "BENCH_b.json").write_text(json.dumps(bad))
    (tmp_path / "BENCH_c.json").write_text("{not json")
    got = lint.run_bench_schema(str(tmp_path))
    assert got == j_lint.run_bench_schema(str(tmp_path)) and len(got) == 4
    monkeypatch.chdir(tmp_path)
    assert lint.main(["--device", "cpu", "--skip-waverace",
                      "--bench-schema"]) == 1


# -- the recorder -----------------------------------------------------------

def test_each_kernel_op_is_one_record():
    g = torch.Generator().manual_seed(0)
    state = torch.randint(0, 9, (32,), dtype=torch.int32, generator=g)
    idx = torch.randint(-1, 32, (64,), dtype=torch.int32, generator=g)
    val = torch.randint(0, 9, (64,), dtype=torch.int32, generator=g)
    C, B = torch.randn(3, 8, 4, generator=g), torch.randn(3, 8, 4, generator=g)
    x, a = torch.randn(3, 8, 5, generator=g), -torch.rand(3, 8, generator=g)
    calls = {
        "repro_torch::coarse_commit":
            lambda: coarse_commit_kernel(state, idx, val, op="add",
                                         stats=True),
        "repro_torch::fused_route_commit":
            lambda: fused_route_commit_kernel(state, idx, val, base=3,
                                              op="max"),
        "repro_torch::bucket_count":
            lambda: bucket_count_kernel(idx, 7),
        "repro_torch::ssd_chunk": lambda: ssd_chunk_kernel(C, B, x, a),
    }
    counters = [coarse_commit_kernel, fused_route_commit_kernel,
                bucket_count_kernel, ssd_chunk_kernel]
    before = [k.launches for k in counters]
    for name, call in calls.items():
        _, rec = record(call)
        ops = [r for r in rec.records if r.name.startswith("repro_torch::")]
        assert [r.name for r in ops] == [name] and not ops[0].scoped
        # nothing of the plain version inside the op is recorded (the
        # fused wrapper turns an int base into a tensor before the op)
        assert all(r.name in (name, "aten::lift_fresh", "aten::view")
                   for r in rec.records), [r.name for r in rec.records]
    # the CPU runs the plain versions: no kernel was launched
    assert [k.launches for k in counters] == before


def test_keys_follow_storages_not_addresses():
    """Views share their base's key; a storage allocated after another
    died gets a new key, whether or not it reuses the address."""
    rec = OpRecorder()
    a = torch.zeros(1024)
    k = rec.key(a)
    assert rec.key(a[3:]) == k and rec.key(a.view(32, 32)) == k
    del a
    assert rec.key(torch.zeros(1024)) != k


def test_commit_scope_counts_outermost_entries():
    scope = commit_scope()
    depth, entries = scope.depth, scope.entries
    with commit_scope():
        with commit_scope():
            assert scope.depth == depth + 2
        assert scope.entries == entries + 1
    assert scope.depth == depth and scope.entries == entries + 1
