"""Serving graph queries on the PyTorch/CUDA port — GraphService
quickstart.  The port of ``examples/serve_queries.py``, step for step.

Many independent user queries fuse into ONE AAM wave along whichever
batch axis fits: same-graph queries (BFS sources, SSSP roots,
personalized PageRank seeds, s-t pairs) as lanes on composite commit
keys ``lane * V + v``; same-kind queries across tenant graphs —
including the whole-graph kinds, coloring and Boruvka MST, which have
no lane form — as a graph batch on the tenants' disjoint-union key
space; MIXED same-kind traffic as one lanes×graphs PRODUCT wave on
keys ``lane * Vtot + offset[g] + v``.  The service picks the axis at
drain time and pads each axis up its own power-of-two ladder.  The
final stanzas serve asynchronously (a ContinuousServer drain loop
admits on a deadline window and boards late arrivals onto the running
product wave) and trace one drain into ``TRACE_example.json`` in the
working directory.

  PYTHONPATH=src python examples_torch/serve_queries.py            # the card
  PYTHONPATH=src python examples_torch/serve_queries.py --device cpu
"""
import argparse
import dataclasses
import json
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.graphs.algorithms.bfs import bfs
from repro_torch.graphs.generators import kronecker, random_weights
from repro_torch.obs import trace as OT
from repro_torch.obs import wavetap as OW
from repro_torch.serve.continuous import ContinuousServer
from repro_torch.serve.durable import ServiceSupervisor
from repro_torch.serve.graph_service import GraphService
from repro_torch.serve.queries import (BfsQuery, ColoringQuery, MstQuery,
                                       PprQuery, SsspQuery, StConnQuery)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- construction: one service, two tenant graphs ----------------------
    g = kronecker(scale=9, edge_factor=8, seed=1, device=dev)
    gw = random_weights(g, seed=2)
    svc = GraphService(max_lanes=8)      # default spec: calibrated "auto"
    svc.register_graph("social", g)
    svc.register_graph("roads", gw)
    print(f"graph |V|={g.num_vertices} |E|={g.num_edges}; "
          f"lane ladder {svc.lane_ladder}\n")

    # --- submit: a mixed stream of queries ---------------------------------
    rng = np.random.default_rng(0)
    sources = rng.choice(g.num_vertices, 8, replace=False)
    tickets = [svc.submit("social", BfsQuery(int(s))) for s in sources[:5]]
    tickets += [svc.submit("social", PprQuery(int(sources[5]), iters=10)),
                svc.submit("roads", SsspQuery(int(sources[6]))),
                svc.submit("social", StConnQuery(int(sources[0]),
                                                 int(sources[7])))]
    print(f"submitted {svc.stats.submitted} queries -> "
          f"{svc.pending()} distinct pending")

    # --- drain: fused lane waves -------------------------------------------
    t0 = time.perf_counter()
    done = svc.drain()
    dt = time.perf_counter() - t0
    print(f"drained {len(done)} tickets in {dt * 1e3:.1f} ms over "
          f"{svc.stats.waves} fused waves "
          f"({svc.stats.lanes_executed} lanes, "
          f"{svc.stats.lanes_padded} ladder padding)\n")

    dist = svc.result(tickets[0])
    print(f"BFS from {int(sources[0])}: "
          f"reached {int((torch.as_tensor(dist) < 2 ** 30).sum())} vertices")
    rank = torch.as_tensor(svc.result(tickets[5]))
    print(f"PPR from {int(sources[5])}: top vertex "
          f"{int(torch.argmax(rank))}, mass {float(rank.sum()):.4f}")
    print(f"s-t connected({int(sources[0])}, {int(sources[7])}): "
          f"{svc.result(tickets[7])}")

    # --- the cache: a repeat visitor costs nothing -------------------------
    t = svc.submit("social", BfsQuery(int(sources[0])))
    assert torch.equal(torch.as_tensor(svc.result(t)),
                       torch.as_tensor(dist))
    print(f"\nrepeat query served from cache "
          f"(cache_hits={svc.stats.cache_hits}, no new wave: "
          f"waves={svc.stats.waves})")

    # --- mixed tenants: the GRAPH batch axis -------------------------------
    # Six more tenant graphs, one query each: single-query tenants fuse
    # ACROSS graphs (one wave over the disjoint union) instead of one wave
    # per tenant — and whole-graph queries (coloring, MST) become
    # servable, since independent graphs trivially share a wave.
    for i in range(6):
        svc.register_graph(f"tenant{i}", kronecker(
            scale=8 - (i % 2), edge_factor=6, seed=10 + i, device=dev))
    gw0 = svc.stats.graph_waves
    tickets = [svc.submit(f"tenant{i}", BfsQuery(0)) for i in range(6)]
    tickets += [svc.submit(f"tenant{i}", ColoringQuery()) for i in range(6)]
    tickets.append(svc.submit("tenant0", MstQuery()))
    t0 = time.perf_counter()
    svc.drain()
    dt = time.perf_counter() - t0
    print(f"\nmixed tenants: drained {len(tickets)} single-query tenants in "
          f"{dt * 1e3:.1f} ms over {svc.stats.graph_waves - gw0} "
          f"graph-batch waves ({svc.stats.graphs_batched} graphs incl. "
          f"{svc.stats.graphs_padded} ladder padding)")
    colors = torch.as_tensor(svc.result(tickets[6]))
    print(f"tenant0 coloring: {int(colors.max()) + 1} colors")
    comp, weight, n_edges = svc.result(tickets[-1])
    print(f"tenant0 MST: {int(n_edges)} edges, weight {float(weight):.1f}")

    # --- durability: kill the service mid-drain, restore, finish -----------
    # A ServiceSupervisor wraps the service with a snapshot Checkpointer
    # plus a submit journal (WAL): acknowledged tickets survive a host
    # loss even if no snapshot ran since.  The snapshot carries the
    # learned autotune entries and ladder M levels, so the restored
    # service is WARM — it re-serves without a re-calibration timing run.
    ckdir = tempfile.mkdtemp(prefix="svc_ck_")
    sup = ServiceSupervisor(svc, Checkpointer(ckdir), log=lambda *_: None)
    sup.save()                           # warm snapshot (results + tuner)
    tickets = [sup.submit("social", BfsQuery(int(s))) for s in sources[2:7]]

    # simulate the host dying on the drain's first fused wave
    kill_wave = svc._wave_i

    def host_lost(where, i):
        if i == kill_wave:
            raise RuntimeError("host lost")
    svc.fault_injector = host_lost
    t0 = time.perf_counter()
    sup.drain()                          # crash -> restore -> re-drain
    dt = time.perf_counter() - t0
    svc = sup.service                    # the restored instance
    rows = [sup.result(t) for t in tickets]  # every acknowledged ticket
    assert all(torch.equal(torch.as_tensor(r), bfs(g, int(s)).dist)
               for r, s in zip(rows, sources[2:7]))
    print(f"\nkilled wave {kill_wave}, supervisor restored snapshot + WAL "
          f"and finished {len(rows)} tickets in {dt * 1e3:.1f} ms "
          f"(restarts={sup.restarts}, "
          f"post-restore timing runs={svc.stats.timing_runs})")

    # --- continuous batching: async submits board the running wave ---------
    # ContinuousServer runs drain() on a background thread behind a
    # deadline admission window; submit() is non-blocking and late
    # arrivals claim free cells of the RUNNING lanes×graphs product wave
    # instead of waiting for the next drain.  Wrapping the supervisor
    # keeps the WAL journaling, so an async crash mid-wave restores and
    # still answers every ticket.
    fresh = rng.choice(g.num_vertices, 4, replace=False)
    with ContinuousServer(sup, max_wait_s=0.01) as cs:
        hot = [cs.submit("social", BfsQuery(int(s))) for s in fresh[:3]]
        tail = [cs.submit(f"tenant{i}", BfsQuery(1)) for i in range(3)]
        late = cs.submit("social", BfsQuery(int(fresh[3])))  # boards late
        rows = cs.results(hot + tail + [late], timeout=120)
    svc = sup.service
    lat = sorted((cs.done_at[t] - cs.submit_at[t]) * 1e3
                 for t in hot + tail + [late])
    print(f"\ncontinuous batching: {len(rows)} async tickets over "
          f"{svc.stats.product_waves} product wave(s) "
          f"({svc.stats.product_cells} cells, "
          f"{svc.stats.product_cells_padded} padded); "
          f"latency p50={lat[len(lat) // 2]:.1f}ms max={lat[-1]:.1f}ms")
    shutil.rmtree(ckdir, ignore_errors=True)

    # --- observability: trace one traced drain, export everything ----------
    # The tracer (repro_torch.obs) has three layers: a span Tracer on the
    # serving path (submit/admit/drain/wave spans, restore/WAL-replay
    # instants), a wave tap in the round loops (per-round conflicts,
    # commit density, ladder level — only planted when tracing is on), and
    # the metrics registry behind svc.stats (Prometheus text +
    # aam-metrics/v1 JSON).  REPRO_TRACE=1 turns all of it on globally;
    # here it is scoped to one service instead.
    tracer = OT.Tracer(enabled=True)
    svc2 = GraphService(tracer=tracer,
                        spec=dataclasses.replace(svc.spec, trace=True))
    svc2.register_graph("social", g)
    for s in sources[:4]:
        svc2.submit("social", BfsQuery(int(s)))
    OW.clear()
    svc2.drain()
    OW.flush_to(tracer)                  # device-tid wave events
    doc = tracer.to_chrome()
    assert not OT.validate_trace(doc) and not tracer.open_spans()
    with open("TRACE_example.json", "w") as f:
        json.dump(doc, f)
    spans = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    print(f"\nwavescope: {len(doc['traceEvents'])} trace events "
          f"({', '.join(sorted(set(spans))[:4])}, ...) -> "
          f"TRACE_example.json (open in https://ui.perfetto.dev)")
    print("registry snapshot: "
          f"{svc2.stats.total_waves} total waves; prometheus text "
          f"{len(svc2.stats.registry.prometheus_text().splitlines())} lines")


if __name__ == "__main__":
    main()
