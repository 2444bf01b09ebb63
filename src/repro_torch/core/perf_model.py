"""The paper's performance model (§5.3): T(N) = B + A·N.

Fine (atomics-analogue) and coarse (transaction-analogue) commit paths are
both affine in the number of modified vertices N; coarse has higher
intercept B (per-transaction dispatch/commit overhead) but lower slope A
(conflict resolution on-chip instead of per-element memory-system round
trips).  The crossing point N* = (B_c - B_f) / (A_f - A_c) predicts the
transaction size where coarsening starts to win; ``select_m`` uses it to
pre-select M*.

A copy of :mod:`repro.core.perf_model` (numpy only), kept apart so that
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LinearFit:
    intercept: float       # B — per-activity overhead
    slope: float           # A — per-vertex cost
    r2: float

    def predict(self, n):
        return self.intercept + self.slope * np.asarray(n)


def fit(ns, times) -> LinearFit:
    ns = np.asarray(ns, dtype=np.float64)
    ts = np.asarray(times, dtype=np.float64)
    a, b = np.polyfit(ns, ts, 1)
    pred = a * ns + b
    ss_res = float(np.sum((ts - pred) ** 2))
    ss_tot = float(np.sum((ts - ts.mean()) ** 2)) or 1e-30
    return LinearFit(intercept=float(b), slope=float(a),
                     r2=1.0 - ss_res / ss_tot)


def crossing_point(fine: LinearFit, coarse: LinearFit) -> float | None:
    """N above which one coarse activity beats N fine activities.

    Fine path cost for N vertices: N · (B_f + A_f)   (one activity each).
    Coarse path: B_c + A_c · N  (one activity, N vertices)."""
    per_vertex_fine = fine.intercept + fine.slope
    if per_vertex_fine <= coarse.slope:
        return None            # coarsening never wins
    return coarse.intercept / (per_vertex_fine - coarse.slope)


def select_m(fine: LinearFit, coarse: LinearFit, *, cap: int = 4096,
             safety: float = 2.0) -> int:
    """Pick a transaction size comfortably past the crossing point but
    bounded by the VMEM-capacity analogue ``cap`` (paper: HTM buffer).

    The result is a power of two and NEVER exceeds ``cap``: rounding up
    could overshoot the speculative-state capacity (e.g. ``cap=3000`` with
    ``n*safety >= 2049`` used to return 4096), so an overshooting round-up
    falls back to the largest power of two <= cap."""
    n = crossing_point(fine, coarse)
    if n is None:
        return 1
    m = int(max(2, min(cap, n * safety)))
    p = 1 << (m - 1).bit_length()      # round to power of two tiles
    while p > cap:                     # respect the HTM-buffer cap
        p >>= 1
    return max(p, 1)
