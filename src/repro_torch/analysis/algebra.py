"""Commit-op algebra registry + at-least-once reachability pass.

A copy of :mod:`repro.analysis.algebra` (it uses no framework) over the
port's own modules: ``OPS`` from :mod:`repro_torch.core.commit`, the
replay sites from :data:`repro_torch.serve.durable.REPLAY_GUARDS` and
the algorithm modules under ``repro_torch.graphs.algorithms``.

An HTM transaction serializes *some* order; the AAM pipeline reorders
freely (coalescing sorts by key, the exchange interleaves shards, the
adaptive ladder re-tiles), so every commit op must declare — and
provably have — the algebraic properties that make all orders
equivalent:

* **commutative + associative**: any batch order commits to the same
  state (``min``/``max``/``or``/``add``; float ``add`` only up to
  rounding — flagged ``float_reassoc``).
* **idempotent**: delivering a message twice is harmless — required
  wherever a batch can replay (the at-least-once paths below).
  ``add`` is NOT idempotent: replayed mass double-counts.
* **order_dependent** (``first``): not commutative; legal only at
  unfused single-graph sites, and only with a deterministic tiebreak
  so runs are reproducible across backends.

:func:`check_algebra` verifies every declaration *exhaustively* at
small widths (all argument triples over a small value set), in both
directions — a property declared False must exhibit a counterexample.

:func:`check_replay_paths` then walks the registered at-least-once
replay sites (:data:`repro_torch.serve.durable.REPLAY_GUARDS`) and checks
each guard witness is still present in the shipped source: a WAL
replay, degraded-mesh re-home, or restore path that lost its
exactly-once guard while a non-idempotent op (pagerank/ppr ``add``) is
in the fleet is reported as a finding.
"""
from __future__ import annotations

import dataclasses
import importlib
import inspect
import itertools
import re


@dataclasses.dataclass(frozen=True)
class OpAlgebra:
    """Declared algebra of one commit op (binary combine ``f``)."""
    op: str
    commutative: bool
    associative: bool
    idempotent: bool
    order_dependent: bool = False
    float_reassoc: bool = False          # assoc exact only in exact arith
    deterministic_tiebreak: str | None = None


ALGEBRA = {
    "min": OpAlgebra("min", commutative=True, associative=True,
                     idempotent=True),
    "max": OpAlgebra("max", commutative=True, associative=True,
                     idempotent=True),
    "or": OpAlgebra("or", commutative=True, associative=True,
                    idempotent=True),
    "add": OpAlgebra("add", commutative=True, associative=True,
                     idempotent=False, float_reassoc=True),
    # first-writer-wins: f(a, b) = a — associative and idempotent but
    # NOT commutative; commit order picks the winner, so backends pin
    # the tiebreak to the minimum message index (see
    # repro_torch.core.commit._first_winner and the sanitizer's rank-aware
    # replay).
    "first": OpAlgebra("first", commutative=False, associative=True,
                       idempotent=True, order_dependent=True,
                       deterministic_tiebreak="min message index"),
}

# binary combine semantics, on plain python ints/bools (exact arith so
# the exhaustive check is decisive; float reassociation is a separate,
# declared hazard)
_COMBINE = {
    "min": min,
    "max": max,
    "add": lambda a, b: a + b,
    "or": lambda a, b: a | b,
    "first": lambda a, b: a,
}

_VALUES = {
    "or": (0, 1),
    # small ints exercise sign, zero, and ties
    "min": tuple(range(-3, 4)),
    "max": tuple(range(-3, 4)),
    "add": tuple(range(-3, 4)),
    "first": tuple(range(-3, 4)),
}


def _holds_comm(f, vals):
    return all(f(a, b) == f(b, a) for a, b in itertools.product(vals, vals))


def _holds_assoc(f, vals):
    return all(f(f(a, b), c) == f(a, f(b, c))
               for a, b, c in itertools.product(vals, vals, vals))


def _holds_idem(f, vals):
    return all(f(a, a) == a for a in vals)


def check_algebra() -> list[str]:
    """Exhaustively verify every registry declaration; returns findings
    (empty = every declaration matches the op's actual behaviour)."""
    findings = []
    from repro_torch.core.commit import OPS
    for op in OPS:
        if op not in ALGEBRA:
            findings.append(
                f"algebra: commit op {op!r} has no OpAlgebra declaration "
                f"— the analyzer cannot reason about its reorder safety")
    for op, decl in ALGEBRA.items():
        f, vals = _COMBINE[op], _VALUES[op]
        for prop, holds in (("commutative", _holds_comm(f, vals)),
                            ("associative", _holds_assoc(f, vals)),
                            ("idempotent", _holds_idem(f, vals))):
            declared = getattr(decl, prop)
            if declared and not holds:
                findings.append(
                    f"algebra: op {op!r} declared {prop} but a "
                    f"counterexample exists at width <= 3")
            if not declared and holds:
                findings.append(
                    f"algebra: op {op!r} declared NOT {prop} but no "
                    f"counterexample exists over {vals} — declaration "
                    f"is stale")
        if decl.order_dependent and decl.deterministic_tiebreak is None:
            findings.append(
                f"algebra: order-dependent op {op!r} has no declared "
                f"deterministic tiebreak — results would vary by backend")
        if decl.order_dependent == decl.commutative:
            findings.append(
                f"algebra: op {op!r} order_dependent must be the "
                f"negation of commutative")
    return findings


_OP_RE = re.compile(r'''(?:op\s*=\s*|make_commit_step\(\s*\w+\s*,\s*)
                        ["']([a-z]+)["']''', re.VERBOSE)

ALGO_MODULES = (
    "repro_torch.graphs.algorithms.bfs",
    "repro_torch.graphs.algorithms.sssp",
    "repro_torch.graphs.algorithms.pagerank",
    "repro_torch.graphs.algorithms.coloring",
    "repro_torch.graphs.algorithms.stconn",
    "repro_torch.graphs.algorithms.boruvka",
)


def ops_in_module(modname: str) -> set[str]:
    """Commit ops a module's waves use (source census: ``op="..."``
    keywords plus ``make_commit_step(spec, "op", ...)`` sites)."""
    mod = importlib.import_module(modname)
    from repro_torch.core.commit import OPS
    return {m.group(1) for m in _OP_RE.finditer(inspect.getsource(mod))
            if m.group(1) in OPS}


def check_fused_order_dependence() -> list[str]:
    """Order-dependent ops (``first``) may not appear in distributed /
    batch-fused rounds: the exchange interleaves shards arbitrarily, so
    even a deterministic tiebreak yields mesh-shape-dependent answers.
    Single-shard sites are fine (one batch, one documented order)."""
    findings = []
    for modname in ALGO_MODULES:
        mod = importlib.import_module(modname)
        src = inspect.getsource(mod)
        for fn_name, fn in inspect.getmembers(mod, inspect.isfunction):
            if fn.__module__ != modname:
                continue
            if not (fn_name.startswith("distributed")
                    or "batched_over" in fn_name):
                continue
            try:
                fsrc = inspect.getsource(fn)
            except OSError:
                fsrc = src
            for m in _OP_RE.finditer(fsrc):
                op = m.group(1)
                decl = ALGEBRA.get(op)
                if decl is not None and decl.order_dependent:
                    findings.append(
                        f"algebra: {modname}.{fn_name} commits "
                        f"order-dependent op {op!r} on a distributed/"
                        f"fused wave — shard interleave makes the "
                        f"result mesh-shape-dependent")
    return findings


def check_replay_paths() -> list[str]:
    """Verify every registered at-least-once replay site still carries
    its idempotence guard, and report non-idempotent ops in the fleet.

    The serving stack has three paths that can re-deliver work after a
    crash/shrink; each is exactly-once only because of a specific guard
    (result-keyed WAL replay, chunk-snapshot rollback, keyed publish).
    pagerank/ppr commit ``add`` — NOT idempotent — so losing any guard
    turns a replay into double-counted mass.  The guards are declared in
    :data:`repro_torch.serve.durable.REPLAY_GUARDS` with a source *witness*
    string; a missing witness means the guard was refactored away (or
    moved — re-point the declaration)."""
    findings = []
    from repro_torch.serve.durable import REPLAY_GUARDS
    non_idem = sorted(
        op for modname in ALGO_MODULES for op in ops_in_module(modname)
        if not ALGEBRA[op].idempotent)
    for site in REPLAY_GUARDS:
        try:
            mod = importlib.import_module(site.module)
            obj = mod
            for part in site.qualname.split("."):
                obj = getattr(obj, part)
            src = inspect.getsource(obj)
        except (ImportError, AttributeError, OSError) as e:
            findings.append(
                f"replay: at-least-once site {site.name} "
                f"({site.module}.{site.qualname}) cannot be resolved "
                f"({e}) — guard unverifiable")
            continue
        if site.witness not in src:
            findings.append(
                f"replay: at-least-once site {site.name} lost its "
                f"idempotence guard (witness {site.witness!r} no longer "
                f"in {site.module}.{site.qualname}); non-idempotent "
                f"commit ops in the fleet: {non_idem or 'none'} — "
                f"replayed batches would double-apply")
    return findings
