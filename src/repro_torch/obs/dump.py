"""``python -m repro_torch.obs.dump`` — the ``make trace`` demo.

Port of :mod:`repro.obs.dump`.  Runs a mixed-tenant continuous-batching
workload with tracing forced on (one hot graph holding several query
kinds + a tail of single-query tenants, the product-axis shape) on
``--device`` (default ``cuda``), then writes:

* ``--out`` (``TRACE_serve.json``) — Chrome/Perfetto trace (open in
  https://ui.perfetto.dev or ``chrome://tracing``): drain/admit/
  product_wave serving spans on the serve row, wavetap commit events on
  the device row, submit instants threading them together;
* ``--metrics`` + ``.prom`` — Prometheus text exposition of the service
  registry (wave/ladder counters + the submit-to-answer latency
  histogram);
* ``--metrics`` + ``.json`` — the ``aam-metrics/v1`` snapshot.

Both documents are schema-checked before writing — a nonzero exit means
the exporters and validators disagree.
"""
from __future__ import annotations

import json
import os
import sys


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.dump")
    ap.add_argument("--out", default="TRACE_serve.json")
    ap.add_argument("--metrics", default="METRICS_serve")
    ap.add_argument("--scale", type=int, default=6,
                    help="graph size exponent for the hot graph")
    ap.add_argument("--device", default="cuda",
                    help="device the graphs and waves live on")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    device = resolve_device(args.device)
    os.environ["REPRO_TRACE"] = "1"     # before any service is built
    from repro_torch.graphs.generators import erdos_renyi, kronecker
    from repro_torch.obs import trace as OT
    from repro_torch.obs import wavetap as OW
    from repro_torch.obs.metrics import validate_metrics_json
    from repro_torch.serve.continuous import ContinuousServer
    from repro_torch.serve.graph_service import GraphService
    from repro_torch.serve.queries import BfsQuery, PprQuery, SsspQuery

    tracer = OT.Tracer(enabled=True)
    OT.set_tracer(tracer)
    OW.clear()

    svc = GraphService(tracer=tracer)
    n = 1 << args.scale
    svc.register_graph("hot", kronecker(args.scale, 8, seed=7,
                                        device=device))
    for i in range(3):
        svc.register_graph(f"t{i}", erdos_renyi(n, 4.0, seed=i,
                                                device=device))

    queries = [("hot", BfsQuery(s)) for s in range(4)]
    queries += [("hot", SsspQuery(s)) for s in range(2)]
    queries += [(f"t{i}", BfsQuery(i)) for i in range(3)]
    queries += [("hot", PprQuery(0))]

    with ContinuousServer(svc, max_wait_s=0.01, max_batch=8) as cs:
        tickets = [cs.submit(gid, q) for gid, q in queries]
        cs.results(tickets, timeout=600.0)
        # resubmit one — a cache hit shows up as a zero-length drain
        cs.result(cs.submit("hot", BfsQuery(0)), timeout=600.0)

    OW.flush_to(tracer)
    doc = tracer.to_chrome()
    findings = OT.validate_trace(doc)
    reg = svc.stats.registry
    snap = reg.snapshot()
    findings += validate_metrics_json(snap)
    if tracer.open_spans():
        findings.append(f"orphan spans: {tracer.open_spans()}")
    if findings:
        for f in findings:
            print(f"TRACE FINDING: {f}", file=sys.stderr)
        return 1

    with open(args.out, "w") as f:
        json.dump(doc, f)
    with open(args.metrics + ".prom", "w") as f:
        f.write(reg.prometheus_text())
    with open(args.metrics + ".json", "w") as f:
        json.dump(snap, f, indent=1)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    insts = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    lat = reg.histogram("aam_submit_to_answer_seconds")
    print(f"{args.out}: {len(spans)} spans, {len(insts)} instants "
          f"(open in https://ui.perfetto.dev)")
    print(f"{args.metrics}.prom / .json: "
          f"{len(snap['counters'])} counters, "
          f"latency p50={lat.quantile(0.5) * 1e3:.3g}ms "
          f"p99={lat.quantile(0.99) * 1e3:.3g}ms over {lat.count} queries")
    return 0


if __name__ == "__main__":
    sys.exit(main())
