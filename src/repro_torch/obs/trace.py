"""Span tracer + Chrome/Perfetto export.

One :class:`Tracer` holds a flat event list; spans are "X" complete
events (begin/end read the tracer's clock), instants are "i" events
(restore, WAL replay, mesh shrink).  The tracer's clock defaults to
``time.perf_counter`` but a service constructed with an injected clock
binds its tracer to THE SAME clock, so fake-clock tests see
deterministic span timestamps.

Everything is inert unless the tracer is *active*: ``enabled=None``
(the default) follows the ``REPRO_TRACE`` environment variable, so the
zero-impact-when-off guarantee extends to the host side — an inactive
span context manager performs no clock reads and allocates nothing.

``to_chrome()`` exports ``{"traceEvents": [...]}`` (Chrome tracing /
Perfetto JSON, microsecond timestamps); :func:`validate_trace` is the
schema smoke check the tests run over every exported document.

A copy of :mod:`repro.obs.trace` (it uses no framework), kept apart so
that the port imports nothing of the JAX package; the schema
``aam-trace/v1`` is the same.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

TRACE_SCHEMA = "aam-trace/v1"

# tid convention for the one-process serving stack: host-side serving
# spans vs device-side wavetap events render as two named rows
TID_SERVE = 0
TID_DEVICE = 1


def trace_enabled() -> bool:
    """The global toggle: ``REPRO_TRACE`` set to anything but ``0``."""
    return os.environ.get("REPRO_TRACE", "").strip() not in ("", "0")


class Tracer:
    """Collects trace events; thread-safe (the continuous drain loop
    publishes from its own thread while clients submit).

    clock:   0-arg callable returning seconds.  Bind the service's
             injected clock so spans and ``ServiceStats`` timing agree.
    enabled: True/False pins the tracer on/off; None (default) follows
             ``REPRO_TRACE`` at each use site.
    """

    def __init__(self, clock=None, enabled: bool | None = None):
        self.clock = clock if clock is not None else time.perf_counter
        self.enabled = enabled
        self.events: list[dict] = []
        self._lock = threading.Lock()
        # per-thread stacks of open spans (orphan detection)
        self._open: dict[int, list[dict]] = {}

    @property
    def active(self) -> bool:
        return trace_enabled() if self.enabled is None else self.enabled

    # -- recording --------------------------------------------------------

    def begin(self, name: str, *, cat: str = "serve", tid: int = TID_SERVE,
              args: dict | None = None) -> None:
        """Open a span (reads the clock once).  Prefer :meth:`span`."""
        if not self.active:
            return
        ev = {"name": name, "cat": cat, "tid": tid, "ts": self.clock(),
              "args": dict(args or {})}
        with self._lock:
            self._open.setdefault(threading.get_ident(), []).append(ev)

    def end(self, args: dict | None = None) -> None:
        """Close the innermost open span of this thread (one clock
        read); no-op if none is open (e.g. tracing flipped mid-span)."""
        if not self.active:
            return
        now = self.clock()
        with self._lock:
            stack = self._open.get(threading.get_ident())
            if not stack:
                return
            ev = stack.pop()
            ev["ph"] = "X"
            ev["dur"] = max(now - ev["ts"], 0.0)
            if args:
                ev["args"].update(args)
            self.events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "serve", tid: int = TID_SERVE,
             args: dict | None = None):
        """``with tracer.span("drain"): ...`` — the try/finally
        guarantees a fault inside the span still closes it, so a crash →
        restore run never leaves orphans."""
        if not self.active:
            yield
            return
        self.begin(name, cat=cat, tid=tid, args=args)
        try:
            yield
        finally:
            self.end()

    def complete(self, name: str, ts: float, dur: float, *,
                 cat: str = "serve", tid: int = TID_SERVE,
                 args: dict | None = None) -> None:
        """Record a finished span from timestamps the caller ALREADY
        read — ``GraphService.drain`` reuses its own t0/dt so tracing
        adds zero clock reads there (a fake-clock test pins the exact
        read count)."""
        if not self.active:
            return
        ev = {"name": name, "cat": cat, "tid": tid, "ts": ts,
              "dur": max(dur, 0.0), "ph": "X", "args": dict(args or {})}
        with self._lock:
            self.events.append(ev)

    def instant(self, name: str, *, cat: str = "serve",
                tid: int = TID_SERVE, ts: float | None = None,
                args: dict | None = None) -> None:
        """Record an instant event (restore, WAL replay, mesh shrink)."""
        if not self.active:
            return
        ev = {"name": name, "cat": cat, "tid": tid,
              "ts": self.clock() if ts is None else ts, "ph": "i",
              "args": dict(args or {})}
        with self._lock:
            self.events.append(ev)

    # -- inspection / export ----------------------------------------------

    def open_spans(self) -> list[str]:
        """Names of spans begun but never ended — MUST be empty in a
        well-formed trace (the fault-path test asserts it)."""
        with self._lock:
            return [ev["name"] for stack in self._open.values()
                    for ev in stack]

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self._open.clear()

    def to_chrome(self) -> dict:
        """Chrome tracing / Perfetto JSON: seconds -> microseconds."""
        with self._lock:
            events = [dict(e) for e in self.events]
        out = []
        for e in sorted(events, key=lambda e: e["ts"]):
            ev = {"name": e["name"], "cat": e["cat"], "ph": e["ph"],
                  "pid": 1, "tid": e["tid"],
                  "ts": round(e["ts"] * 1e6, 3), "args": e["args"]}
            if e["ph"] == "X":
                ev["dur"] = round(e["dur"] * 1e6, 3)
            else:
                ev["s"] = "p"        # process-scoped instant
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"schema": TRACE_SCHEMA}}


def validate_trace(doc) -> list[str]:
    """Schema smoke check over an exported trace document; returns
    findings (empty = valid).  The tests run it over every trace the
    port emits."""
    findings = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["trace: document has no traceEvents list"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["trace: traceEvents is not a list"]
    for i, e in enumerate(events):
        missing = {"name", "ph", "ts", "pid", "tid"} - set(e)
        if missing:
            findings.append(f"trace: event {i} missing {sorted(missing)}")
            continue
        if not isinstance(e["ts"], (int, float)):
            findings.append(f"trace: event {i} ts not numeric")
        if e["ph"] == "X":
            if not isinstance(e.get("dur"), (int, float)) or e["dur"] < 0:
                findings.append(
                    f"trace: X event {i} ({e['name']}) bad dur")
        elif e["ph"] == "i":
            if e.get("s") not in ("g", "p", "t"):
                findings.append(
                    f"trace: instant {i} ({e['name']}) bad scope")
        elif e["ph"] not in ("B", "E", "M"):
            findings.append(f"trace: event {i} unknown phase {e['ph']!r}")
    return findings


# -- the process-global tracer ------------------------------------------
# Services share it by default (one continuous-batching run = one
# trace); engine instants (mesh shrink) land here too.  A test injects
# its own Tracer(clock=fake) either via set_tracer or per-service.

_TRACER: Tracer | None = None
_TRACER_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    global _TRACER
    with _TRACER_LOCK:
        if _TRACER is None:
            _TRACER = Tracer()
        return _TRACER


def set_tracer(tracer: Tracer | None) -> None:
    global _TRACER
    with _TRACER_LOCK:
        _TRACER = tracer
