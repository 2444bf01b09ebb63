"""Metrics registry: counters, gauges, log-bucket histograms.

A :class:`Registry` is cheap enough to exist per service.  This module
is a copy of :mod:`repro.obs.metrics` (it uses no framework), kept apart
so that the port imports nothing of the JAX package; the schema
``aam-metrics/v1`` is the same.

Two export formats:

* :meth:`Registry.prometheus_text` — Prometheus text exposition
  (cumulative ``le`` buckets, ``_sum``/``_count``);
* :meth:`Registry.snapshot` — an ``aam-metrics/v1`` JSON document,
  schema-checked by :func:`validate_metrics_json`.

Histograms use base-2 log buckets: ``quantile(q)`` returns the upper
bound of the bucket where the cumulative count crosses ``q`` — so a
bench-computed percentile always lands within one bucket of the
histogram's answer (the acceptance check for the latency histogram).
"""
from __future__ import annotations

import math
import threading

METRICS_SCHEMA = "aam-metrics/v1"

# 2^-20 s (~1 us) .. 2^6 s (64 s): covers a cache-hit submit through a
# cold-compile drain in 27 buckets
_DEFAULT_BOUNDS = tuple(2.0 ** e for e in range(-20, 7))


class Counter:
    """Monotone counter (``set`` exists only for the ServiceStats
    back-compat view, which assigns via augmented attribute ops)."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def set(self, v) -> None:
        self.value = v


class Gauge:
    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n


class Histogram:
    """Log-bucket histogram over fixed upper bounds (+Inf implicit)."""

    def __init__(self, name: str, help: str = "", bounds=_DEFAULT_BOUNDS):
        self.name, self.help = name, help
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket where the cumulative count crosses
        ``q * count`` (inf if the overflow bucket holds it); nan when
        empty."""
        if self.count == 0:
            return math.nan
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                return self.bounds[i] if i < len(self.bounds) \
                    else math.inf
        return math.inf

    def bucket_of(self, v: float) -> int:
        """Index of the bucket ``v`` falls in — the within-one-bucket
        acceptance check compares ``bucket_of(bench_p99)`` against
        ``bucket_of(quantile(0.99))``."""
        for i, b in enumerate(self.bounds):
            if v <= b:
                return i
        return len(self.bounds)


class Registry:
    """Get-or-create metric namespace; all mutation under one lock-free
    discipline (CPython attribute ops are atomic enough for counters;
    creation is locked)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  bounds=_DEFAULT_BOUNDS) -> Histogram:
        return self._get(name, Histogram, help=help, bounds=bounds)

    # -- export -----------------------------------------------------------

    def prometheus_text(self) -> str:
        """Prometheus text exposition format."""
        lines = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {m.value}")
            else:
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for b, c in zip(m.bounds, m.counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{b:.9g}"}} {cum}')
                cum += m.counts[-1]
                lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{name}_sum {m.sum}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """The ``aam-metrics/v1`` JSON document."""
        out = {"schema": METRICS_SCHEMA, "counters": {}, "gauges": {},
               "histograms": {}}
        with self._lock:
            metrics = list(self._metrics.items())
        for name, m in metrics:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = {
                    "count": m.count, "sum": m.sum,
                    "buckets": [[b, c] for b, c in
                                zip(m.bounds + (math.inf,), m.counts)]}
        return out


def validate_metrics_json(doc) -> list[str]:
    """Schema smoke check for :meth:`Registry.snapshot` documents."""
    findings = []
    if not isinstance(doc, dict):
        return ["metrics: document is not an object"]
    if doc.get("schema") != METRICS_SCHEMA:
        findings.append(f"metrics: schema {doc.get('schema')!r} != "
                        f"{METRICS_SCHEMA!r}")
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(doc.get(section), dict):
            findings.append(f"metrics: missing section {section!r}")
    for name, v in (doc.get("counters") or {}).items():
        if not isinstance(v, (int, float)):
            findings.append(f"metrics: counter {name} not numeric")
    for name, h in (doc.get("histograms") or {}).items():
        if not isinstance(h, dict) or not {"count", "sum",
                                           "buckets"} <= set(h):
            findings.append(f"metrics: histogram {name} malformed")
            continue
        counts = [c for _, c in h["buckets"]]
        if sum(counts) != h["count"]:
            findings.append(f"metrics: histogram {name} bucket counts "
                            f"{sum(counts)} != count {h['count']}")
    return findings
