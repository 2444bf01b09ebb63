"""Fault tolerance: the supervised restart core over a Checkpointer and a
straggler watchdog.

Port of :mod:`repro.runtime.fault_tolerance`.  On a real fleet a
supervisor wraps per-unit-of-work execution; a host failure surfaces as
an exception (collective timeout / lost device) → restore from the last
committed checkpoint and replay.  The restart accounting and budget
live in the generic :class:`Supervisor`;
:class:`repro_torch.serve.durable.ServiceSupervisor` (ticket-journaled
query service) subclasses it.  The reference's ``TrainSupervisor``
comes with the training stack (ROADMAP Queue 1 item 9).

The watchdog implements the paper-adjacent straggler story at the system
level: step times exceeding ``threshold ×`` a running median are flagged;
the fleet hook (``on_straggler``) would evict/reshuffle the slow host —
here it feeds metrics and tests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.checkpoint.checkpointer import Checkpointer


@dataclasses.dataclass
class WatchdogStats:
    steps: int = 0
    flagged: int = 0
    median_s: float = 0.0


class StragglerWatchdog:
    """Flags steps slower than ``threshold`` x the running median."""

    def __init__(self, threshold: float = 3.0, window: int = 32,
                 on_straggler: Callable[[int, float], None] | None = None):
        self.threshold = threshold
        self.window = window
        self.times: list[float] = []
        self.stats = WatchdogStats()
        self.on_straggler = on_straggler

    def observe(self, step: int, dt: float) -> bool:
        self.stats.steps += 1
        hist = self.times[-self.window:]
        flagged = False
        if len(hist) >= 8:
            med = sorted(hist)[len(hist) // 2]
            self.stats.median_s = med
            if dt > self.threshold * med:
                flagged = True
                self.stats.flagged += 1
                if self.on_straggler:
                    self.on_straggler(step, dt)
        self.times.append(dt)
        return flagged


class Supervisor:
    """Restart/replay core of the query service (and, with item 9, the
    train loop): counts faults against a restart budget and resolves
    which committed step to restore from.  Subclasses own the work loop
    and what "replay" means."""

    def __init__(self, ckpt: Checkpointer, *, max_restarts: int = 10):
        self.ckpt = ckpt
        self.max_restarts = max_restarts
        self.restarts = 0

    def recover_step(self, exc: BaseException, *, what: str = "work",
                     log=print) -> int:
        """Account one fault.  Raises if the restart budget is exhausted
        or there is nothing committed to restore from; otherwise returns
        the step to restore (after draining any in-flight async save)."""
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError(
                f"exceeded {self.max_restarts} restarts") from exc
        last = self.ckpt.latest_step()
        log(f"[supervisor] {what} failed ({type(exc).__name__}: {exc}); "
            f"restoring from {last}")
        if last is None:
            raise exc
        self.ckpt.wait()
        return last
