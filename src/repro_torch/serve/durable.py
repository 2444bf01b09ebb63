"""Durable serving: snapshot/restore + supervised crash recovery for
:class:`repro_torch.serve.graph_service.GraphService`.

Port of :mod:`repro.serve.durable`, with the same snapshot meta and the
same checkpoint domains, so a snapshot written by either package
restores in the other.  A service holds four kinds of warm state that
are expensive (or impossible) to recompute after a crash:

* **graphs** — every registered tenant CSR;
* **results + cache** — answered tickets and the ``(graph_id, query)``
  result cache;
* **in-flight ticket journal** — acknowledged-but-unanswered
  submissions (the queue) plus a write-ahead log of submissions since
  the last snapshot;
* **adaptive state** — the autotuner's calibration fits/race verdicts
  and the per-(kind, graph) learned conflict-ladder levels.

:class:`ServiceSnapshot` is the portable unit: array payload as
checkpoint *domains* (``Checkpointer.save_domains``), python structure
as the manifest's JSON meta.  :func:`restore_service` rebuilds a WARM
service on the device the caller names — the first post-restore drain
runs zero timed calibrations (fits are imported, asserted via
``ServiceStats.timing_runs``) and commits at the learned M
(``CommitSpec.seed_m``).

:class:`ServiceSupervisor` wires it to the generic restart core
(:class:`repro_torch.runtime.fault_tolerance.Supervisor`): ``submit``
appends to the WAL, ``save`` commits a snapshot (truncating the WAL with
it), and a drain that faults mid-wave restores the last snapshot,
replays the WAL under the original ticket ids, and drains again — no
acknowledged ticket lost, no ticket answered twice (replay skips tickets
the snapshot already accounts for).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import autotune as AT
from repro_torch.core import commit as C
from repro_torch.graphs.csr import graph_on
from repro_torch.runtime.fault_tolerance import Supervisor
from repro_torch.serve.graph_service import GraphService
from repro_torch.serve.queries import query_from_dict, query_to_dict

SNAPSHOT_VERSION = 1
_DOMAINS = ("graphs", "cache", "results")


# -- at-least-once replay sites ----------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplaySite:
    """One path that can re-deliver already-submitted work.

    ``witness`` is a source fragment of the guard that makes the replay
    effectively exactly-once: refactoring a guard away (or moving it
    without re-pointing the declaration) would let non-idempotent commit
    ops (pagerank/ppr ``add``) double-apply on replay, so the tests hold
    every witness to its function's source."""
    name: str
    module: str
    qualname: str
    witness: str
    note: str


REPLAY_GUARDS = (
    ReplaySite(
        name="wal-replay",
        module="repro_torch.serve.graph_service",
        qualname="GraphService._replay_submit",
        witness="if ticket in self._results",
        note="ServiceSupervisor WAL replay re-enters acknowledged "
             "submissions; answered tickets are skipped so a ticket is "
             "never drained (and its adds never committed) twice."),
    ReplaySite(
        name="degraded-mesh-rehome",
        module="repro_torch.core.engine",
        qualname="_run_degraded",
        witness="global_state, scalars, carry = snap",
        note="a host drop re-homes the LAST COMPLETED chunk snapshot "
             "onto the shrunk mesh — rounds re-execute from a committed "
             "state, never half-applied on top of it."),
    ReplaySite(
        name="continuous-restore",
        module="repro_torch.serve.continuous",
        qualname="ContinuousServer._publish",
        witness="svc._bounded_put(svc._results, t, row",
        note="restore re-runs the wave; results publish keyed by ticket "
             "id into the results map, so a ticket observed twice "
             "overwrites with an identical row instead of appending."),
)


# -- graph ids / result rows over the JSON boundary -------------------------

def _gid_enc(gid) -> dict:
    if isinstance(gid, bool) or not isinstance(gid, (str, int)):
        raise TypeError(f"snapshot graph ids must be str or int, got "
                        f"{type(gid).__name__} ({gid!r})")
    return {"t": "s" if isinstance(gid, str) else "i", "v": gid}


def _gid_dec(d: dict):
    return str(d["v"]) if d["t"] == "s" else int(d["v"])


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _row_enc(row, arrays: list) -> dict:
    """One result row -> meta entry; array parts append to ``arrays``
    (the domain payload, order = meta order)."""
    if isinstance(row, (bool, np.bool_)):
        return {"f": "bool", "v": bool(row)}
    if isinstance(row, tuple):                   # mst: (comp, weight, n)
        comp, weight, n_edges = row
        arrays.append(_host(comp))
        return {"f": "mst", "w": float(weight), "n": int(n_edges)}
    arrays.append(_host(row))
    return {"f": "array"}


def _row_dec(entry: dict, arrays, device):
    if entry["f"] == "bool":
        return entry["v"]
    if entry["f"] == "mst":
        return (torch.from_numpy(next(arrays)).to(device),
                torch.tensor(entry["w"], dtype=torch.float32, device=device),
                torch.tensor(entry["n"], dtype=torch.int32, device=device))
    return torch.from_numpy(next(arrays)).to(device)


@dataclasses.dataclass
class ServiceSnapshot:
    """One frozen service: JSON-portable ``meta`` (structure) + numpy
    ``domains`` (array payload, keyed by :data:`_DOMAINS`)."""
    meta: dict
    domains: dict

    @property
    def next_ticket(self) -> int:
        return self.meta["next_ticket"]


def build_snapshot(svc: GraphService) -> ServiceSnapshot:
    graphs_meta, graph_arrays = [], []
    for gid, g in svc._graphs.items():
        graphs_meta.append({"id": _gid_enc(gid), "v": g.num_vertices,
                            "e": g.num_edges})
        graph_arrays += [_host(g.indptr), _host(g.src), _host(g.dst),
                         _host(g.weights)]
    cache_meta, cache_arrays = [], []
    if svc._cache is not None:
        for (gid, q), row in svc._cache.items():
            cache_meta.append({"id": _gid_enc(gid),
                               "q": query_to_dict(q),
                               "row": _row_enc(row, cache_arrays)})
    results_meta, result_arrays = [], []
    for ticket, row in svc._results.items():
        results_meta.append({"t": int(ticket),
                             "row": _row_enc(row, result_arrays)})
    queue_meta = []
    for (gid, _fk), lanes in svc._queue.items():
        for q, tickets in lanes.items():
            queue_meta.append({"id": _gid_enc(gid), "q": query_to_dict(q),
                               "tickets": [int(t) for t in tickets]})
    spec = svc.spec
    meta = {
        "schema": "aam-service-snapshot",
        "version": SNAPSHOT_VERSION,
        "config": {
            "spec": dataclasses.asdict(spec),
            "max_lanes": svc.max_lanes, "max_graphs": svc.max_graphs,
            "capacity": svc.capacity, "axis": svc.axis,
            "cache": svc._cache is not None,
            "max_results": svc.max_results, "max_cache": svc.max_cache,
            "product": svc.product,
        },
        "graphs": graphs_meta,
        "cache": cache_meta,
        "results": results_meta,
        "queue": queue_meta,
        "next_ticket": svc._next_ticket,
        "m_learned": [[kind, _gid_enc(gid), int(m)]
                      for (kind, gid), m in svc._m_learned.items()
                      if isinstance(gid, (str, int))
                      and not isinstance(gid, bool)],
        "autotune": AT.DEFAULT_TUNER.export_entries(),
    }
    return ServiceSnapshot(meta=meta, domains={
        "graphs": graph_arrays, "cache": cache_arrays,
        "results": result_arrays})


def _spec_from(d: dict) -> C.CommitSpec:
    """The config's CommitSpec; fields the port's spec lacks (the
    reference's ``interpret``) are dropped."""
    names = {f.name for f in dataclasses.fields(C.CommitSpec)}
    return C.CommitSpec(**{k: v for k, v in d.items() if k in names})


def restore_service(snap: ServiceSnapshot, *, mesh=None, clock=None,
                    device="cuda") -> GraphService:
    """A warm :class:`GraphService` from ``snap``, its graphs and result
    rows on ``device``."""
    device = resolve_device(device)
    meta = snap.meta
    if meta.get("version", 0) > SNAPSHOT_VERSION:
        raise ValueError(f"snapshot version {meta.get('version')} is newer "
                         f"than this build ({SNAPSHOT_VERSION})")
    cfg = meta["config"]
    svc = GraphService(spec=_spec_from(cfg["spec"]),
                       max_lanes=cfg["max_lanes"],
                       max_graphs=cfg["max_graphs"], mesh=mesh,
                       capacity=cfg["capacity"], axis=cfg["axis"],
                       cache=cfg["cache"],
                       max_results=cfg["max_results"],
                       max_cache=cfg["max_cache"],
                       # snapshots from before the product axis lack it
                       product=cfg.get("product", True),
                       # clocks are process resources (like meshes):
                       # re-injected at restore, never serialized
                       clock=clock)
    ga = iter(snap.domains["graphs"])
    for entry in meta["graphs"]:
        indptr, src, dst, weights = (next(ga) for _ in range(4))
        g = graph_on(indptr, src, dst, weights, int(entry["v"]), device)
        svc.register_graph(_gid_dec(entry["id"]), g)
    ca = iter(snap.domains["cache"])
    if svc._cache is not None:
        for entry in meta["cache"]:        # insertion order = FIFO order
            svc._cache[(_gid_dec(entry["id"]),
                        query_from_dict(entry["q"]))] = \
                _row_dec(entry["row"], ca, device)
    ra = iter(snap.domains["results"])
    for entry in meta["results"]:
        svc._results[int(entry["t"])] = _row_dec(entry["row"], ra, device)
    for entry in meta["queue"]:
        q = query_from_dict(entry["q"])
        gid = _gid_dec(entry["id"])
        lanes = svc._queue.setdefault((gid, q.fuse_key()), {})
        lanes.setdefault(q, []).extend(int(t) for t in entry["tickets"])
    svc._next_ticket = int(meta["next_ticket"])
    svc._m_learned = {(kind, _gid_dec(gid)): int(m)
                      for kind, gid, m in meta.get("m_learned", [])}
    # warm adaptive state: imported fits mean the first drain's policy
    # resolution is a pure cache lookup — zero timed micro-benchmarks
    AT.DEFAULT_TUNER.import_entries(meta.get("autotune", {}))
    return svc


# -- checkpoint-backed persistence ------------------------------------------

def save_snapshot(ckpt: Checkpointer, snap: ServiceSnapshot,
                  step: int | None = None, *, blocking: bool = True,
                  _pre_commit=None) -> int:
    """Commit a snapshot as a domain checkpoint (crash-consistent: the
    COMMITTED marker lands after every leaf; ``_pre_commit`` raising
    simulates a crash mid-save and leaves the previous snapshot intact)."""
    if step is None:
        last = ckpt.latest_step()
        step = (last + 1) if last is not None else 1
    ckpt.save_domains(step, dict(snap.domains),
                      versions={d: SNAPSHOT_VERSION for d in _DOMAINS},
                      meta=snap.meta, blocking=blocking,
                      _pre_commit=_pre_commit)
    return step


def load_snapshot(ckpt: Checkpointer,
                  step: int | None = None) -> tuple[ServiceSnapshot, int]:
    meta = ckpt.meta(step)
    if meta.get("schema") != "aam-service-snapshot":
        raise ValueError(f"checkpoint at {ckpt.dir} is not a service "
                         f"snapshot (schema {meta.get('schema')!r})")
    domains = {}
    got = None
    for d in _DOMAINS:
        arrays, _version, got = ckpt.load_domain_arrays(d, step)
        domains[d] = arrays
    return ServiceSnapshot(meta=meta, domains=domains), got


def _device_of(svc: GraphService):
    """The device of the service's graphs ("cuda" before any is
    registered)."""
    for g in svc._graphs.values():
        return g.device
    return "cuda"


class ServiceSupervisor(Supervisor):
    """Crash-resumable facade over a GraphService.

    ``submit`` acknowledges a ticket only after journaling it to the WAL
    (JSON-lines next to the checkpoints); ``save`` commits a snapshot
    and truncates the WAL; ``drain`` restores-and-replays on a fault.
    ``mesh`` is re-attached on every restore (process resource), and the
    restored service lands on the device of the service it replaces."""

    def __init__(self, service: GraphService, ckpt: Checkpointer, *,
                 max_restarts: int = 10, log=print):
        super().__init__(ckpt, max_restarts=max_restarts)
        self.service = service
        self.log = log
        self._wal = ckpt.dir / "wal.jsonl"

    # -- journaled admission ---------------------------------------------

    def submit(self, graph_id, query) -> int:
        ticket = self.service.submit(graph_id, query)
        with open(self._wal, "a") as f:
            f.write(json.dumps({"t": ticket, "id": _gid_enc(graph_id),
                                "q": query_to_dict(query)}) + "\n")
        return ticket

    def result(self, ticket: int):
        return self.service.result(ticket)

    # -- snapshot lifecycle ----------------------------------------------

    def save(self, step: int | None = None, *, blocking: bool = True,
             _pre_commit=None) -> int:
        """Snapshot the service; the WAL restarts empty at the snapshot
        (its tickets are now accounted inside it).  A crash between
        commit and truncate only leaves already-accounted WAL lines —
        replay skips tickets below the snapshot's ``next_ticket``."""
        step = save_snapshot(self.ckpt, self.service.snapshot(), step,
                             blocking=blocking, _pre_commit=_pre_commit)
        self.ckpt.wait()
        self._wal.write_text("")
        return step

    def restore(self, *, mesh=None) -> GraphService:
        """Last committed snapshot + WAL replay -> a warm service bound
        to this supervisor (original ticket ids preserved)."""
        snap, step = load_snapshot(self.ckpt)
        # the clock survives restore the same way the mesh does: it is a
        # process resource, re-attached rather than serialized
        svc = restore_service(snap, mesh=mesh, clock=self.service.clock,
                              device=_device_of(self.service))
        # so is the tracer: carrying it over keeps a crash -> restore ->
        # re-drain run a SINGLE trace (one timeline, replay instants
        # between the faulted spans and the re-executed ones)
        svc.tracer = self.service.tracer
        svc.tracer.instant("restore", cat="durable",
                           args={"step": step,
                                 "graphs": len(svc._graphs)})
        base = snap.next_ticket
        replayed = 0
        if self._wal.exists():
            for line in self._wal.read_text().splitlines():
                if not line.strip():
                    continue
                entry = json.loads(line)
                if int(entry["t"]) < base:
                    continue        # already inside the snapshot
                svc._replay_submit(_gid_dec(entry["id"]),
                                   query_from_dict(entry["q"]),
                                   int(entry["t"]))
                replayed += 1
        svc.tracer.instant("wal_replay", cat="durable",
                           args={"replayed": replayed,
                                 "pending": svc.pending()})
        self.log(f"[service] restored snapshot step {step} "
                 f"({len(svc._graphs)} graphs, {svc.pending()} pending)")
        self.service = svc
        return svc

    # -- supervised execution --------------------------------------------

    def drain(self, *, mesh=None) -> dict:
        """``service.drain()`` with restore-and-replay on any fault.
        The faulted service instance is abandoned; the restored one
        re-executes every unanswered acknowledged ticket."""
        try:
            return self.service.drain()
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — any fault → restore
            self.recover_step(e, what="drain", log=self.log)
            self.restore(mesh=mesh if mesh is not None else
                         self.service.mesh)
            return self.service.drain()
