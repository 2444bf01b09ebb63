"""Per-commit and per-round wave telemetry, read on the host.

The tuner's signals (per-round conflicts, commit density, the ladder
level M) live on the card.  The port's round loops are host loops, so a
tap is a plain hook that runs after the commit or round it records:

* :func:`tap_commit_step` wraps the ``step`` returned by
  ``repro_torch.core.autotune.make_commit_step``, one record per commit
  (every single-shard loop goes through that one hook);
* :func:`round_recorder` is the engine's tap, one record per round per
  rank (each rank records into its own process's collector).

Each record costs one host read: ``torch.stack(...).tolist()`` of the
counters the commit or round already computed.  With tracing off no tap
is installed, so nothing is read.

Records accumulate in a process-global :class:`Collector`;
:func:`flush_to` turns them into Chrome trace events on the device tid
(span duration = gap to the previous record of the same stream), and
:func:`summary` reduces them to per-run fields (rounds, mean commit
density, ladder moves).  The records' keys and values are those of
:mod:`repro.obs.wavetap`; only ``"t"``, a host clock reading, differs.
"""
from __future__ import annotations

import threading
import time

import torch

from repro_torch.obs import trace as _trace


class Collector:
    """Append-only, lock-guarded record sink."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: list[dict] = []

    def add(self, rec: dict) -> None:
        with self._lock:
            self._records.append(rec)

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    def drain(self) -> list[dict]:
        with self._lock:
            out, self._records = self._records, []
            return out

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


_COLLECTOR = Collector()


def collector() -> Collector:
    return _COLLECTOR


def records() -> list[dict]:
    return _COLLECTOR.records()


def clear() -> None:
    _COLLECTOR.clear()


def host_ints(*xs) -> list[int]:
    """Tensors and ints as Python ints, tensors in one host read."""
    tensors = [x for x in xs if isinstance(x, torch.Tensor)]
    if tensors:
        vals = iter(torch.stack([t.reshape(()).to(torch.int64)
                                 for t in tensors]).tolist())
    return [next(vals) if isinstance(x, torch.Tensor) else int(x)
            for x in xs]


# -- taps ----------------------------------------------------------------


def commit_recorder(label: str, op: str, backend: str):
    """Record one commit of a stream."""
    def cb(conflicts, applied, messages, level):
        conflicts, applied, messages, level = host_ints(
            conflicts, applied, messages, level)
        _COLLECTOR.add({
            "kind": "commit", "label": label, "op": op,
            "backend": backend, "t": time.perf_counter(),
            "conflicts": conflicts, "applied": applied,
            "messages": messages, "level": level})
    return cb


def round_recorder(label: str):
    """Record one round of the engine on this rank."""
    def cb(it, conflicts, subrounds, messages, level, shard):
        it, conflicts, subrounds, messages, level, shard = host_ints(
            it, conflicts, subrounds, messages, level, shard)
        _COLLECTOR.add({
            "kind": "round", "label": label, "t": time.perf_counter(),
            "round": it, "conflicts": conflicts,
            "subrounds": subrounds, "messages": messages,
            "level": level, "shard": shard})
    return cb


def tap_commit_step(step, *, label: str, op: str, backend: str):
    """Wrap a ``make_commit_step`` step with the commit tap: after each
    commit, one record of (conflicts, applied, valid messages, the level
    the step returned)."""
    cb = commit_recorder(label, op, backend)

    def traced_step(state, msgs, level):
        res, lvl = step(state, msgs, level)
        cb(res.conflicts, res.applied, msgs.valid.sum(), lvl)
        return res, lvl

    return traced_step


# -- host-side reductions -------------------------------------------------


def summary(recs: list[dict] | None = None) -> dict:
    """Reduce records to per-run trace fields.

    rounds:       engine round records (shard 0) if any, else the
                  number of commits (one commit per round in the
                  single-shard loops);
    mean_density: mean conflicts/messages over records with routed
                  messages;
    ladder_moves: level changes between consecutive records of the
                  same stream (label);
    commits:      commit records seen.
    """
    recs = _COLLECTOR.records() if recs is None else recs
    rounds = sum(1 for r in recs
                 if r["kind"] == "round" and r.get("shard", 0) == 0)
    commits = sum(1 for r in recs if r["kind"] == "commit")
    dens = [r["conflicts"] / r["messages"] for r in recs
            if r.get("messages", 0) > 0]
    moves, last = 0, {}
    for r in recs:
        key = (r["kind"], r["label"])
        if key in last and r["level"] != last[key]:
            moves += 1
        last[key] = r["level"]
    return {"rounds": rounds if rounds else commits,
            "commits": commits,
            "mean_density": round(sum(dens) / len(dens), 4) if dens
            else 0.0,
            "ladder_moves": moves}


def flush_to(tracer, tid: int = _trace.TID_DEVICE) -> int:
    """Drain the collector into ``tracer`` as device-tid trace events;
    returns the number of records flushed.  Round/commit spans get
    ``dur`` = host gap since the previous record of their stream (the
    first record of a stream is a zero-width span)."""
    recs = _COLLECTOR.drain()
    if not tracer.active:
        return len(recs)
    prev: dict[tuple, float] = {}
    for r in recs:
        key = (r["kind"], r["label"])
        t = r["t"]
        t0 = prev.get(key, t)
        prev[key] = t
        args = {k: v for k, v in r.items()
                if k not in ("kind", "label", "t")}
        name = (f"round[{r['label']}]" if r["kind"] == "round"
                else f"commit[{r['label']}]")
        tracer.complete(name, t0, t - t0, cat=r["kind"], tid=tid,
                        args=args)
    return len(recs)
