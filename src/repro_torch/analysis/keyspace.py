"""Key-space analysis — composite-key disjointness + dtype bounds.

HTM detected conflicts at cache-line granularity; our software commit
detects them by *flat key equality*.  Two different work items (lane,
graph, vertex cells) must therefore never share a flat key — otherwise
their updates silently merge — and the largest flat key must fit the
int32 key pipeline (``fuse_keys`` arithmetic, message targets, and
``commit()``'s drop sentinel at ``key == flat_size``, which needs one
slot of headroom).  ``L × Vtot`` product axes are where the overflow
actually bites: a modest lane budget times a big tenant union wraps
int32 long before either axis would alone, and wrapped keys alias
*other tenants' vertices* — a cross-tenant data corruption, not a
crash.

:func:`analyze_axis` proves both properties for a
``QueryLanes``/``GraphBatch``/``ProductAxis`` (or any duck-typed axis
exposing the same fields): exhaustively for small axes (every valid
coordinate maps to a unique key in ``[0, flat_size)``), by
stride/corner probing for large ones.  All bound arithmetic runs in
python ints — the hazard under analysis is exactly that the int32
pipeline cannot represent these values.

Port of :mod:`repro.analysis.keyspace`: the axes' ``flatten`` takes and
returns tensors here, so the exhaustive proof hands it int64 tensors and
reads the keys back as numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.coalescing import MAX_FLAT_KEYS

# axes up to this many cells get the exhaustive bijection proof
EXHAUSTIVE_LIMIT = 1 << 16


@dataclasses.dataclass
class KeyspaceReport:
    name: str
    kind: str                    # lanes | graphs | product
    flat_size: int               # python-int cell count (never wraps)
    max_key: int                 # flat_size - 1
    headroom: int                # MAX_FLAT_KEYS - max_key
    disjoint: bool | None        # True = proven; None = bound-only
    findings: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings


def _axis_kind(axis) -> str:
    has_lanes = hasattr(axis, "lanes")
    has_sizes = hasattr(axis, "sizes")
    if has_lanes and has_sizes:
        return "product"
    if has_sizes:
        return "graphs"
    return "lanes"


def _flat_size(axis, kind: str) -> int:
    # python-int arithmetic from the declared fields — axis.flat_size
    # itself is trustworthy (same formula) but recomputing here keeps
    # the analyzer honest against a buggy property
    if kind == "lanes":
        return int(axis.lanes) * int(axis.num_vertices)
    if kind == "graphs":
        return sum(int(s) for s in axis.sizes)
    return int(axis.lanes) * sum(int(s) for s in axis.sizes)


def _coords(axis, kind: str):
    """(major, minor) int64 arrays covering every valid cell-coordinate
    pair of a small axis, plus the flatten callable."""
    if kind == "lanes":
        L, V = int(axis.lanes), int(axis.num_vertices)
        l = torch.arange(L).repeat_interleave(V)
        v = torch.arange(V).repeat(L)
        return l, v, axis.flatten
    g1 = torch.cat([torch.full((int(s),), i)
                    for i, s in enumerate(axis.sizes)])
    v1 = torch.cat([torch.arange(int(s)) for s in axis.sizes])
    if kind == "graphs":
        return g1, v1, axis.flatten
    # product: enumerate (lane, graph, local v) through flatten3
    L = int(axis.lanes)
    lane = torch.arange(L).repeat_interleave(g1.numel())
    g = g1.repeat(L)
    v = v1.repeat(L)
    return lane, (g, v), (lambda a, b: axis.flatten3(a, b[0], b[1]))


def _probe_strides(axis, kind: str, flat_size: int) -> list:
    """Large-axis spot check: unit stride on the minor coordinate,
    declared stride on the major, and the max coordinate lands on
    ``flat_size - 1``.  Catches a mis-nested flatten without
    enumerating 2^31 cells."""
    findings = []
    f = {"lanes": lambda a, b: int(axis.flatten(a, b)),
         "graphs": lambda a, b: int(axis.flatten(a, b)),
         "product": lambda a, b: int(axis.flatten(a, b))}[kind]
    if kind == "lanes":
        stride, last_major = int(axis.num_vertices), int(axis.lanes) - 1
        last_minor = int(axis.num_vertices) - 1
    elif kind == "graphs":
        stride = int(axis.sizes[0])          # offset of graph 1
        last_major = len(axis.sizes) - 1
        last_minor = int(axis.sizes[-1]) - 1
        f = lambda a, b: int(axis.flatten(a, b))  # noqa: E731
    else:
        stride = sum(int(s) for s in axis.sizes)
        last_major = int(axis.lanes) - 1
        last_minor = stride - 1              # minor = flat union vertex
    checks = [
        ("flatten(0, 0) == 0", f(0, 0), 0),
        ("unit minor stride", f(0, 1) - f(0, 0), 1),
        ("major stride", f(min(1, last_major), 0) - f(0, 0),
         stride if last_major >= 1 else 0),
        ("max coordinate -> flat_size - 1", f(last_major, last_minor),
         flat_size - 1),
    ]
    for what, got, want in checks:
        if got != want:
            findings.append(
                f"keyspace: {kind} axis stride probe failed — {what}: "
                f"got {got}, expected {want} (composite keys are not "
                f"the documented nesting; cells may alias)")
    return findings


def analyze_axis(axis, name: str | None = None) -> KeyspaceReport:
    """Prove disjointness + int32 bound for one batch axis."""
    kind = _axis_kind(axis)
    flat_size = _flat_size(axis, kind)
    rep = KeyspaceReport(name=name or f"{type(axis).__name__}", kind=kind,
                         flat_size=flat_size, max_key=flat_size - 1,
                         headroom=MAX_FLAT_KEYS - (flat_size - 1),
                         disjoint=None)
    if flat_size > MAX_FLAT_KEYS:
        rep.findings.append(
            f"keyspace: {rep.name} needs {flat_size} flat keys — "
            f"exceeds the int32 key space (max {MAX_FLAT_KEYS} + drop "
            f"sentinel).  fuse_keys/flatten3 arithmetic wraps silently: "
            f"high cells alias OTHER tenants' vertices (cross-tenant "
            f"corruption).  Shrink the wave or upcast to int64 "
            f"end-to-end.")
        # don't evaluate flatten: the int32 pipeline under analysis
        # cannot represent these keys
        return rep
    if flat_size <= EXHAUSTIVE_LIMIT:
        major, minor, flatten = _coords(axis, kind)
        keys = torch.as_tensor(flatten(major, minor)).cpu().numpy() \
            .astype(np.int64)
        in_range = (keys >= 0) & (keys < flat_size)
        if not bool(in_range.all()):
            rep.findings.append(
                f"keyspace: {rep.name} maps coordinates outside "
                f"[0, {flat_size}) — min {int(keys.min())}, "
                f"max {int(keys.max())}")
        if np.unique(keys).size != keys.size:
            dup = int(keys.size - np.unique(keys).size)
            rep.findings.append(
                f"keyspace: {rep.name} composite keys are NOT disjoint "
                f"— {dup} colliding cell pairs; conflicting work items "
                f"would silently merge in one commit")
        rep.disjoint = not rep.findings
    else:
        rep.findings.extend(_probe_strides(axis, kind, flat_size))
        rep.disjoint = None if not rep.findings else False
    return rep


def analyze_axes(axes) -> list[KeyspaceReport]:
    """``axes``: iterable of axis objects or (name, axis) pairs."""
    out = []
    for item in axes:
        if isinstance(item, tuple) and len(item) == 2:
            name, axis = item
        else:
            name, axis = None, item
        out.append(analyze_axis(axis, name=name))
    return out
