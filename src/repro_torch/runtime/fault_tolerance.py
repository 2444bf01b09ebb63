"""Fault tolerance: the supervised restart core over a Checkpointer and a
straggler watchdog.

Port of :mod:`repro.runtime.fault_tolerance`.  On a real fleet a
supervisor wraps per-unit-of-work execution; a host failure surfaces as
an exception (collective timeout / lost device) → restore from the last
committed checkpoint and replay.  The restart accounting and budget
live in the generic :class:`Supervisor`; :class:`TrainSupervisor`
(step-indexed train loop — the data pipeline in
:mod:`repro_torch.data.pipeline` is step-indexed, so replay is exact)
and :class:`repro_torch.serve.durable.ServiceSupervisor`
(ticket-journaled query service) both subclass it.

The watchdog implements the paper-adjacent straggler story at the system
level: step times exceeding ``threshold ×`` a running median are flagged;
the fleet hook (``on_straggler``) would evict/reshuffle the slow host —
here it feeds metrics and tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten


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
    """Restart/replay core shared by the train loop and the query
    service: counts faults against a restart budget and resolves which
    committed step to restore from.  Subclasses own the work loop and
    what "replay" means (step-indexed batches vs journaled tickets)."""

    def __init__(self, ckpt: Checkpointer, *, max_restarts: int = 10):
        self.ckpt = ckpt
        self.max_restarts = max_restarts
        self.restarts = 0

    def recover_step(self, exc: BaseException, *, what: str = "work",
                     log=print) -> int:
        """Account one fault.  Raises if the restart budget is exhausted
        or there is nothing committed to restore from; otherwise returns
        the step to restore (after draining any in-flight async save).

        The drain comes before the lookup: a save started before the
        fault holds a good state, and a step that ends faster than the
        background write would otherwise find it uncommitted (or find
        nothing at all)."""
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError(
                f"exceeded {self.max_restarts} restarts") from exc
        self.ckpt.wait()
        last = self.ckpt.latest_step()
        log(f"[supervisor] {what} failed ({type(exc).__name__}: {exc}); "
            f"restoring from {last}")
        if last is None:
            raise exc
        return last


def restore_template(state: Any) -> tuple[Any, torch.device]:
    """(``state`` as ``meta`` tensors, the device its tensors are on): a
    template for :meth:`Checkpointer.restore` that holds shapes, dtypes
    and the device, never the values.  Leaves that are not tensors
    restore as tensors of their numpy shape and dtype; a state without
    tensors restores onto the CPU."""
    devices = {x.device for x in tree_flatten(state)[0]
               if isinstance(x, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"the state spans {sorted(map(str, devices))}; "
                         f"restore puts every leaf on one device")

    def meta(x):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return tree_map(meta, state), (devices.pop() if devices
                                   else torch.device("cpu"))


class TrainSupervisor(Supervisor):
    """Run a step function with periodic async checkpoints and
    restore-on-failure.  ``fail_injector(step)`` raising simulates a node
    loss (tests); any exception triggers restore + replay."""

    def __init__(self, ckpt: Checkpointer, *, save_every: int = 50,
                 max_restarts: int = 10,
                 watchdog: StragglerWatchdog | None = None):
        super().__init__(ckpt, max_restarts=max_restarts)
        self.save_every = save_every
        self.watchdog = watchdog or StragglerWatchdog()

    def run(self, state: Any, step_fn, data_fn, *, start_step: int,
            num_steps: int, fail_injector=None, log_every: int = 10,
            log=print) -> tuple[Any, int, list]:
        """state: a tree of tensors; step_fn(state, step, batch) ->
        (state, metrics).  Returns (state, final_step, metric_log).
        Step times are host times of the enqueue: a step waits for the
        card only where it reads a value (a logged step, a save)."""
        # Pristine restore template captured BEFORE any step runs: after
        # a fault the in-flight ``state`` may hold corrupted buffers
        # (NaN-poisoned or lost-device tensors) — restore must only
        # depend on its shapes/dtypes/device, never its values.
        template, device = restore_template(state)
        metrics_log = []
        step = start_step
        while step < num_steps:
            try:
                t0 = time.time()
                if fail_injector is not None:
                    fail_injector(step)
                batch = data_fn(step)
                state, metrics = step_fn(state, step, batch)
                dt = time.time() - t0
                slow = self.watchdog.observe(step, dt)
                if slow:
                    log(f"[watchdog] step {step} took {dt:.3f}s "
                        f"(median {self.watchdog.stats.median_s:.3f}s)")
                step += 1
                if step % log_every == 0 or step == num_steps:
                    metrics_log.append((step, device_get(metrics)))
                    log(f"[train] step {step}: {metrics_log[-1][1]}")
                if step % self.save_every == 0:
                    self.ckpt.save(step, state, blocking=False)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — any fault → restart
                self.recover_step(e, what=f"step {step}", log=log)
                state, step = self.ckpt.restore(template, device=device)
        self.ckpt.wait()
        self.ckpt.save(num_steps, state, blocking=True)
        return state, step, metrics_log


def device_get(tree):
    """``tree`` on the host: 0-d tensors as floats, read in one transfer;
    other tensors as numpy arrays; anything else as it is."""
    leaves, treedef = tree_flatten(tree)
    scalars = [x for x in leaves
               if isinstance(x, torch.Tensor) and x.dim() == 0]
    values = iter(torch.stack([x.detach().double() for x in scalars])
                  .cpu().tolist() if scalars else [])
    out = [next(values) if isinstance(x, torch.Tensor) and x.dim() == 0
           else x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
           else x for x in leaves]
    return tree_unflatten(treedef, out)
