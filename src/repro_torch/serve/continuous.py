"""Continuous batching on the lanes×graphs product axis.

Port of :mod:`repro.serve.continuous`.  :meth:`GraphService.drain` is a
synchronous boundary: callers submit, somebody calls drain, everyone
waits for the full batch.  At serving scale the batch never closes —
queries arrive WHILE a wave is running.  :class:`ContinuousServer` runs
the drain as a background loop and turns the product wave's round
boundaries into admission points, the same shape LLM serving stacks use
for prefill-insert-generate continuous batching:

* **deadline admission** — a submitted query starts a wave after at
  most ``max_wait_s`` (or immediately once ``max_batch`` are pending);
  the pure :class:`DeadlineAdmission` policy is fake-clock testable;
* **in-flight insertion** — while a product wave executes in
  ``round_chunk``-round chunks, newly admitted compatible queries (same
  fuse key, a registered graph of the wave's GraphSet, a free (lane,
  graph) cell) BOARD the running wave at the next round boundary instead
  of waiting for the next one.  Disjoint flat key ranges make the late
  cell's answer bit-identical to an idle-service run (float add to
  rounding).  ``ContinuousServer.boarded`` counts the queries that
  joined a running wave (the port's addition);
* **incremental harvest** — converged cells publish their results (and
  free their slots) at each boundary, all found in one host read
  (:meth:`ProductWave.done_cells`); one straggler no longer holds the
  whole batch's latency;
* **supervised recovery** — wrapped around a
  :class:`repro_torch.serve.durable.ServiceSupervisor`, a fault mid-wave
  restores the last snapshot and replays the WAL: every acknowledged
  ticket is answered exactly once, none lost, none doubled.

Whole-graph kinds (coloring, MST) and mesh execution fall back to the
service's synchronous axes inside the same loop; ``product=False`` on
the service degrades the whole loop to the two-axis drain of lane waves
and graph batches.  The wave's tensors are touched only with the lock
held or from the loop thread.
"""
from __future__ import annotations

import threading
import time
from typing import Any

from repro_torch.core import autotune as AT
from repro_torch.obs import wavetap as OW
from repro_torch.serve.graph_service import GraphService
from repro_torch.serve.product_wave import ProductWave
from repro_torch.serve.queries import PRODUCT_KINDS


class DeadlineAdmission:
    """When does a pending batch start?  Pure policy over an injected
    ``now`` — no threads, no wall clock, exactly testable.

    The first pending submission opens a window of ``max_wait_s``; the
    batch is due when the window closes or ``max_batch`` queries are
    pending, whichever is first."""

    def __init__(self, max_wait_s: float = 0.05, max_batch: int = 32):
        self.max_wait_s = float(max_wait_s)
        self.max_batch = int(max_batch)
        self.deadline: float | None = None

    def note(self, now: float) -> None:
        """A submission was queued at ``now``."""
        if self.deadline is None:
            self.deadline = now + self.max_wait_s

    def due(self, now: float, pending: int) -> bool:
        if pending <= 0:
            return False
        return pending >= self.max_batch or (
            self.deadline is not None and now >= self.deadline)

    def remaining(self, now: float) -> float:
        """Seconds until the open window closes (inf if none open)."""
        if self.deadline is None:
            return float("inf")
        return max(0.0, self.deadline - now)

    def reset(self) -> None:
        self.deadline = None


class ContinuousServer:
    """Asynchronous continuous-batching facade over a
    :class:`GraphService` (or a
    :class:`repro_torch.serve.durable.ServiceSupervisor` for
    WAL-journaled, crash-recovered serving).

    ``submit`` is thread-safe and returns a ticket immediately;
    ``result(ticket, timeout=...)`` blocks until the background drain
    loop publishes the answer.  Use as a context manager (or call
    ``start()``/``stop()``)."""

    def __init__(self, service, *, max_wait_s: float = 0.02,
                 max_batch: int = 64, round_chunk: int = 4,
                 poll_s: float = 0.005):
        sup = service if hasattr(service, "service") else None
        self.sup = sup
        self._svc = sup.service if sup is not None else service
        self.admission = DeadlineAdmission(max_wait_s, max_batch)
        self.round_chunk = int(round_chunk)
        self.poll_s = float(poll_s)
        self.lock = threading.RLock()
        self.cond = threading.Condition(self.lock)
        self.submit_at: dict[int, float] = {}
        self.done_at: dict[int, float] = {}
        # queries that joined a running product wave at a round boundary
        self.boarded = 0
        self._voided: set[int] = set()
        self.last_error: BaseException | None = None
        self._stop = False
        self._thread: threading.Thread | None = None

    @property
    def svc(self) -> GraphService:
        """The live service (a supervisor swaps it on restore)."""
        return self.sup.service if self.sup is not None else self._svc

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "ContinuousServer":
        if self._thread is not None:
            raise RuntimeError("already started")
        self._stop = False
        self._thread = threading.Thread(target=self._loop,
                                        name="aam-drain", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self.cond:
            self._stop = True
            self.cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "ContinuousServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client surface ---------------------------------------------------

    def register_graph(self, graph_id, g) -> None:
        with self.lock:
            self.svc.register_graph(graph_id, g)

    def submit(self, graph_id, query) -> int:
        """Thread-safe admission; never blocks on the card.  The
        ticket's submit timestamp (service clock) starts its
        submit-to-answer latency."""
        with self.cond:
            svc = self.svc
            now = svc.clock()
            if self.sup is not None:
                ticket = self.sup.submit(graph_id, query)
            else:
                ticket = svc.submit(graph_id, query)
            self.submit_at[ticket] = now
            if ticket in svc._results:       # cache hit — answered now
                self.done_at[ticket] = now
                # a cache-hit-only cycle never reaches _drain_once, so
                # the drain stats would go stale: count it as a
                # zero-length drain and record the (zero) latency
                svc.stats.drains += 1
                svc.stats.last_drain_s = 0.0
                self._observe_latency(svc, 0.0)
            else:
                self.admission.note(now)
            self.cond.notify_all()
            return ticket

    def result(self, ticket: int, timeout: float | None = None):
        """Block until the drain loop answers ``ticket`` (KeyError for
        voided tickets — their graph was re-registered; TimeoutError
        past ``timeout`` seconds of host time)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cond:
            while True:
                res = self.svc._results
                if ticket in res:
                    return res[ticket]
                if ticket in self._voided:
                    raise KeyError(f"ticket {ticket} voided by "
                                   f"re-registration")
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise TimeoutError(f"ticket {ticket} not "
                                           f"answered in {timeout}s")
                    self.cond.wait(min(left, self.poll_s))
                else:
                    self.cond.wait(self.poll_s)

    def results(self, tickets, timeout: float | None = None) -> list:
        return [self.result(t, timeout) for t in tickets]

    # -- drain loop -------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self.cond:
                while not self._stop:
                    svc = self.svc
                    now = svc.clock()
                    pending = svc.pending()
                    if pending and self.admission.deadline is None:
                        # work with no open window — re-queued after a
                        # fault or replayed by a restore; open one so it
                        # drains without a fresh submit
                        self.admission.note(now)
                    if self.admission.due(now, pending):
                        if (svc.tracer.active
                                and self.admission.deadline is not None):
                            # window opened max_wait_s before the
                            # deadline — reuse timestamps already read
                            t_open = (self.admission.deadline
                                      - self.admission.max_wait_s)
                            svc.tracer.complete(
                                "admit", t_open, max(now - t_open, 0.0),
                                args={"pending": pending})
                        break
                    wait = min(self.poll_s,
                               self.admission.remaining(now))
                    self.cond.wait(wait if wait > 0 else self.poll_s)
                if self._stop:
                    return
                self.admission.reset()
            try:
                self._drain_once()
            except Exception as e:  # noqa: BLE001 — keep serving
                with self.cond:
                    self.last_error = e
                    self.cond.notify_all()

    @staticmethod
    def _observe_latency(svc, dt: float) -> None:
        """Record one submit-to-answer latency in the service registry
        (get-or-create: a supervisor swaps the service on restore)."""
        svc.stats.registry.histogram(
            "aam_submit_to_answer_seconds").observe(max(dt, 0.0))

    def _publish(self, graph_id, q, row, queues) -> None:
        """Answer every ticket of one finished (graph, query) cell —
        caller holds the lock."""
        svc = self.svc
        now = svc.clock()
        if svc._cache is not None:
            svc._bounded_put(svc._cache, (graph_id, q), row,
                             svc.max_cache)
        for t in queues.pop((graph_id, q), ()):
            svc._bounded_put(svc._results, t, row, svc.max_results)
            self.done_at[t] = now
            self._observe_latency(svc, now - self.submit_at.get(t, now))
        self.cond.notify_all()

    def _sweep_voided(self) -> None:
        """Tickets acked but no longer answerable (their queue entries
        were invalidated by a deferred re-registration) — caller holds
        the lock, drain idle."""
        svc = self.svc
        queued = {t for lanes in svc._queue.values()
                  for tickets in lanes.values() for t in tickets}
        for t in self.submit_at:
            if (t not in self.done_at and t not in svc._results
                    and t not in queued):
                self.done_at[t] = svc.clock()
                self._voided.add(t)

    def _drain_once(self) -> None:
        """One admission cycle: product kinds board continuous product
        waves (with mid-wave insertion); everything else takes the
        service's synchronous axes."""
        svc = self.svc
        t0_timing = AT.DEFAULT_TUNER.timed_runs
        t0 = svc.clock()
        with self.lock:
            taken: dict[tuple, dict] = {}
            if svc.product and svc.mesh is None:
                for key in [k for k in svc._queue
                            if k[1][0] in PRODUCT_KINDS]:
                    taken[key] = svc._queue.pop(key)
            svc._drain_depth += 1
        try:
            if any(lanes for lanes in taken.values()):
                self._run_product(taken)
            if svc.pending():
                # coloring / MST / mesh / product=False: synchronous
                # axes, supervised when a supervisor is attached
                done = (self.sup.drain() if self.sup is not None
                        else svc.drain())
                with self.cond:
                    svc = self.svc        # a fault may have swapped it
                    now = svc.clock()
                    for t in done:
                        if t not in self.done_at:
                            self.done_at[t] = now
                            self._observe_latency(
                                svc, now - self.submit_at.get(t, now))
                    self.cond.notify_all()
        except Exception as e:  # noqa: BLE001
            if self.sup is None:
                raise
            # supervised: restore last snapshot + WAL replay; every
            # unanswered acknowledged ticket is back in the queue
            with self.cond:
                self.sup.recover_step(e, what="continuous-drain",
                                      log=self.sup.log)
                self.sup.restore()
                self.last_error = e
                self.cond.notify_all()
        finally:
            with self.cond:
                svc = self.svc
                svc._drain_depth = max(0, svc._drain_depth - 1)
                if svc._drain_depth == 0:
                    svc._apply_deferred_regs()
                self._sweep_voided()
                svc.stats.timing_runs += \
                    AT.DEFAULT_TUNER.timed_runs - t0_timing
                dt = svc.clock() - t0
                svc.stats.drains += 1
                svc.stats.drain_s += dt
                svc.stats.last_drain_s = dt
                if svc.tracer.active:
                    # reuse t0/dt — zero extra clock reads
                    svc.tracer.complete(
                        "drain", t0, dt,
                        args={"product_waves": svc.stats.product_waves,
                              "waves": svc.stats.waves,
                              "graph_waves": svc.stats.graph_waves})
                    OW.flush_to(svc.tracer)
                self.cond.notify_all()

    # -- continuous product waves -----------------------------------------

    def _run_product(self, taken: dict) -> None:
        """Execute the taken (graph, fuse-key) queues as product waves,
        boarding newly submitted compatible queries at round
        boundaries.  On a fault, unfinished queries re-queue under
        their original tickets before the exception propagates (the
        supervised path then restores + replays instead)."""
        svc = self.svc
        # queues: (graph_id, query) -> tickets, the exactly-once ledger
        queues: dict[tuple, list] = {}
        by_fuse: dict[tuple, dict] = {}
        for (gid, fk), lanes in taken.items():
            for q, tickets in lanes.items():
                queues[(gid, q)] = list(tickets)
                by_fuse.setdefault(fk, {}).setdefault(gid, []).append(q)
        try:
            for fk, per_gid in by_fuse.items():
                gids = list(per_gid)
                for lo in range(0, len(gids), svc.max_graphs):
                    self._product_wave(fk, gids[lo:lo + svc.max_graphs],
                                       per_gid, queues)
        except Exception:
            with self.lock:
                for (gid, q), tickets in queues.items():
                    lanes = svc._queue.setdefault((gid, q.fuse_key()), {})
                    tgt = lanes.setdefault(q, [])
                    tgt.extend(t for t in tickets if t not in tgt)
            raise

    def _board(self, wave: ProductWave, fk, gids, waiting, queues,
               inflight) -> None:
        """Fill free cells — leftovers first, then queries submitted
        since the last boundary (same fuse key, a graph already in the
        wave) — caller holds the lock."""
        svc = self.svc
        col = {gid: i for i, gid in enumerate(gids)}
        for gid in gids:
            key = (gid, fk)
            lanes = svc._queue.get(key)
            if not lanes:
                continue
            for q in list(lanes):
                if (gid, q) in inflight or (gid, q) in queues:
                    # joins the in-flight cell / pending leftovers
                    queues.setdefault((gid, q), []).extend(
                        lanes.pop(q))
                    continue
                queues[(gid, q)] = lanes.pop(q)
                waiting.append((gid, q))
            if not lanes:
                del svc._queue[key]
        still = []
        for gid, q in waiting:
            lane = wave.free_cell(col[gid])
            if lane is None:
                still.append((gid, q))
                continue
            wave.insert(lane, col[gid], q)
            inflight[(gid, q)] = (lane, col[gid])
        waiting[:] = still

    def _product_wave(self, fk, gids, per_gid, queues) -> None:
        """One continuous product wave over the graphs ``gids``."""
        svc = self.svc
        kind = fk[0]
        q0 = per_gid[gids[0]][0]
        fuse = {"iters": q0.iters, "d": q0.d} if kind == "ppr" else {}
        depth = max(len(per_gid[g]) for g in gids)
        width = next(w for w in svc.lane_ladder
                     if w >= min(depth, svc.max_lanes))
        wave = ProductWave(kind, svc._graphset(tuple(gids)), width,
                           spec=svc.spec, fuse=fuse,
                           round_chunk=self.round_chunk)
        waiting = [(gid, q) for gid in gids for q in per_gid[gid]]
        inflight: dict[tuple, tuple] = {}
        with self.lock:
            self._board(wave, fk, gids, waiting, queues, inflight)
            svc.stats.product_waves += 1
            svc.stats.product_cells += width * len(gids)
            svc.stats.product_cells_padded += \
                width * len(gids) - len(inflight)
        with svc.tracer.span("product_wave",
                             args={"kind": kind, "lanes": width,
                                   "graphs": len(gids)}):
            while True:
                svc._fault("continuous")
                done = wave.run_chunk()      # the card, lock NOT held
                with self.lock:
                    finished = wave.done_cells()     # one host read
                    for (gid, q), (lane, gi) in list(inflight.items()):
                        if finished[lane, gi]:
                            self._publish(gid, q,
                                          wave.extract(lane, gi), queues)
                            wave.release(lane, gi)
                            del inflight[(gid, q)]
                    boarded = len(inflight)
                    self._board(wave, fk, gids, waiting, queues,
                                inflight)
                    boarded = len(inflight) - boarded
                    if boarded:
                        svc.stats.product_cells_padded -= boarded
                        self.boarded += boarded
                if done and not inflight and not waiting:
                    return
