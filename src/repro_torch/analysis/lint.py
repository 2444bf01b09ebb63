"""aamlint CLI — ``python -m repro_torch.analysis.lint``.

Port of :mod:`repro.analysis.lint`.  Runs every static pass over the
port's pipeline and exits nonzero on findings:

* **algebra** — commit-op declarations verified exhaustively; no
  order-dependent op on a distributed/fused wave; every at-least-once
  replay site still carries its idempotence guard
  (:mod:`repro_torch.analysis.algebra`);
* **keyspace** — composite-key disjointness + int32 bound for
  representative ``QueryLanes``/``GraphBatch``/``ProductAxis`` shapes
  (:mod:`repro_torch.analysis.keyspace`);
* **waverace** — race detection over recorded rounds of all six
  algorithms on each axis kind plus the ``ProductWave`` chunk bodies
  (:mod:`repro_torch.analysis.waverace`), on the ``--backend`` tier and
  the ``--device`` (default ``cuda``, as every entry point of the port).

``--module pkg.mod`` additionally lints a module's declared surfaces —
``LINT_AXES`` (axis objects or ``(name, axis)`` pairs for the keyspace
pass), ``LINT_TRACEABLES`` (``(name, fn_of_state, example_state)`` for
the race pass), ``LINT_ALGORITHMS`` (``(name, AlgorithmSpec, graph)``
or ``AlgorithmSpec`` run on a default tiny graph).

``--bench-schema`` also validates the committed ``BENCH_*.json``
trajectory files; ``--trace-off-clean`` proves that tracing off records
nothing (see :func:`run_trace_off_clean`).

    python -m repro_torch.analysis.lint --device cpu --trace-off-clean
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import pathlib
import sys
from types import SimpleNamespace

from repro_torch import resolve_device
from repro_torch.core.commit import BACKENDS, CommitSpec


def _print(msg: str) -> None:
    print(msg, flush=True)


def run_algebra() -> list[str]:
    from repro_torch.analysis import algebra
    return (algebra.check_algebra()
            + algebra.check_fused_order_dependence()
            + algebra.check_replay_paths())


# representative shapes: the tiny trio gets the exhaustive bijection
# proof, the serving-scale trio exercises the stride probe + int32
# headroom arithmetic near real deployments (L lanes x multi-M unions)
def _default_axes():
    from repro_torch.core.coalescing import GraphBatch, ProductAxis, QueryLanes
    return [
        ("QueryLanes(8, 97)", QueryLanes(8, 97)),
        ("GraphBatch(7, 13, 29)", GraphBatch((7, 13, 29))),
        ("ProductAxis(4, (7, 13, 29))", ProductAxis(4, (7, 13, 29))),
        ("QueryLanes(64, 2^20)", QueryLanes(64, 1 << 20)),
        ("GraphBatch(3 x ~2^20)",
         GraphBatch((1 << 18, 1 << 19, 1 << 20))),
        ("ProductAxis(8, 3 x ~2^20)",
         ProductAxis(8, (1 << 18, 1 << 19, 1 << 20))),
    ]


def run_keyspace(axes=None) -> list[str]:
    from repro_torch.analysis import keyspace
    findings = []
    for rep in keyspace.analyze_axes(axes if axes is not None
                                     else _default_axes()):
        proof = {True: "disjoint (exhaustive)", False: "NOT disjoint",
                 None: "bound-checked"}[rep.disjoint]
        _print(f"  keyspace {rep.name}: {rep.flat_size} keys, "
               f"headroom {rep.headroom}, {proof}")
        findings.extend(rep.findings)
    return findings


def run_waverace(extra_traceables=(), *, spec: CommitSpec | None = None,
                 device="cuda") -> list[str]:
    from repro_torch.analysis import waverace
    findings = []
    for rep in waverace.check_all(extra_traceables=extra_traceables,
                                  spec=spec, device=device):
        status = "ok" if rep.ok else "RACE"
        _print(f"  waverace {rep.name}: {status} "
               f"(commits={rep.commits}, kernel commits="
               f"{rep.kernel_commits}, state reads={rep.reads})")
        findings.extend(f"{f.where}: {f.detail}" for f in rep.findings)
    return findings


def run_module(modname: str, *, spec: CommitSpec | None = None,
               device="cuda") -> list[str]:
    """Lint one module's declared LINT_* surfaces."""
    from repro_torch.analysis import keyspace, waverace
    mod = importlib.import_module(modname)
    findings = []
    for rep in keyspace.analyze_axes(getattr(mod, "LINT_AXES", ())):
        findings.extend(rep.findings)
    for name, fn, example in getattr(mod, "LINT_TRACEABLES", ()):
        rep = waverace.check_traceable(name, fn, example)
        findings.extend(f"{f.where}: {f.detail}" for f in rep.findings)
    algos = getattr(mod, "LINT_ALGORITHMS", ())
    if algos:
        g, _ = waverace._tiny_graphs(device=device)
        for item in algos:
            if isinstance(item, tuple):
                name, alg, graph = item
            else:
                name, alg, graph = item.name, item, g
            cap = SimpleNamespace(alg=alg, g=graph, batch=None)
            rep = waverace.check_algorithm(name, cap, spec)
            findings.extend(f"{f.where}: {f.detail}"
                            for f in rep.findings)
    if not (hasattr(mod, "LINT_AXES") or hasattr(mod, "LINT_TRACEABLES")
            or hasattr(mod, "LINT_ALGORITHMS")):
        findings.append(
            f"module {modname} declares no LINT_AXES / LINT_TRACEABLES "
            f"/ LINT_ALGORITHMS — nothing to lint")
    return findings


def run_trace_off_clean(*, device="cuda") -> list[str]:
    """Prove the zero-impact-when-off guarantee of the wave taps: with
    tracing off (no ``REPRO_TRACE``, ``CommitSpec(trace=False)``) one
    round of each algorithm's engine loop and each ProductWave chunk body
    installs no :mod:`repro_torch.obs.wavetap` recorder and adds no
    record; one positive control (``trace=True``) must record, so the
    check is never vacuous.  The rounds commit on ``coarse``, as the
    reference's check does (the taps do not depend on the tier).  Also
    schema-smokes the trace and metrics JSON validators over freshly
    built documents."""
    from repro_torch.analysis import waverace
    from repro_torch.core import engine as E
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs import wavetap
    from repro_torch.serve.product_wave import lint_traceables
    findings: list[str] = []
    spec = CommitSpec()                  # coarse: no calibration
    saved = os.environ.pop("REPRO_TRACE", None)
    try:
        with waverace._no_env_sanitize():
            mesh = make_mesh(device=device)

            def one_round(cap, sp):
                """(records added, tap installed) by one engine round."""
                r = E._Runner(cap.alg, mesh, cap.g, axis="data",
                              capacity=64, m=None, spec=sp, batch=cap.batch,
                              max_subrounds=8)
                before = len(wavetap.records())
                r.run(r.local(r.state0), r.scalars0, r.zero_carry(), 1)
                return len(wavetap.records()) - before, r.tap is not None

            # one runner per algorithm — the tap placement is per-engine,
            # not per-wrapper, so the distributed/lanes/graphs variants of
            # one algorithm share a round loop
            seen: dict[str, tuple] = {}
            for label, cap in waverace.capture_algorithms(device=device):
                seen.setdefault(cap.alg.name, (label, cap))
            for name, (label, cap) in sorted(seen.items()):
                added, tapped = one_round(cap, spec)
                dirty = added or tapped
                _print(f"  trace-off engine {label}: "
                       f"{'RECORDED' if dirty else 'clean'}")
                if dirty:
                    findings.append(
                        f"trace-off: {label} round loop recorded {added} "
                        f"wavetap record(s) with tracing OFF")
            for name, fn, example in lint_traceables(spec=spec,
                                                     device=device):
                before = len(wavetap.records())
                fn(example)
                added = len(wavetap.records()) - before
                _print(f"  trace-off product {name}: "
                       f"{'RECORDED' if added else 'clean'}")
                if added:
                    findings.append(
                        f"trace-off: product chunk {name} recorded "
                        f"{added} wavetap record(s) with tracing OFF")
            # positive control: trace=True MUST record, or the "clean"
            # verdicts above prove nothing
            label0, cap0 = sorted(seen.items())[0][1]
            added, tapped = one_round(cap0, dataclasses.replace(
                spec, trace=True))
            if not (added and tapped):
                findings.append(
                    "trace-off: positive control failed — "
                    "CommitSpec(trace=True) recorded nothing; the check is "
                    "vacuous")
            else:
                _print(f"  trace-off control {label0}: {added} record(s) "
                       f"with trace=True")
    finally:
        if saved is not None:
            os.environ["REPRO_TRACE"] = saved
    # schema smoke: the validators must accept what we actually emit
    from repro_torch.obs import metrics as OM
    from repro_torch.obs import trace as OT
    tr = OT.Tracer(enabled=True)
    with tr.span("smoke", args={"k": 1}):
        tr.instant("mark")
    findings += [f"trace-off: {f}"
                 for f in OT.validate_trace(tr.to_chrome())]
    reg = OM.Registry()
    reg.counter("aam_smoke").inc(3)
    reg.gauge("aam_g").set(0.5)
    reg.histogram("aam_h").observe(0.01)
    findings += [f"trace-off: {f}"
                 for f in OM.validate_metrics_json(reg.snapshot())]
    if not reg.prometheus_text().endswith("\n"):
        findings.append("trace-off: Prometheus text does not end in a "
                        "newline")
    _print("  trace-off schemas: trace + metrics validators clean")
    return findings


BENCH_TOP_KEYS = {"schema", "sizes", "platform", "rows", "summary"}
BENCH_ROW_KEYS = {"suite", "backend", "name", "us_per_call", "derived"}
BENCH_SCHEMA = "aam-bench/v1"


def run_bench_schema(root: str = ".") -> list[str]:
    findings = []
    paths = sorted(pathlib.Path(root).glob("BENCH_*.json"))
    if not paths:
        _print("  bench-schema: no BENCH_*.json files found")
    for p in paths:
        try:
            d = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError) as e:
            findings.append(f"bench: {p.name} unreadable: {e}")
            continue
        missing = BENCH_TOP_KEYS - set(d)
        if missing:
            findings.append(
                f"bench: {p.name} missing top-level keys {sorted(missing)}")
        if d.get("schema") != BENCH_SCHEMA:
            findings.append(
                f"bench: {p.name} schema {d.get('schema')!r} != "
                f"{BENCH_SCHEMA!r}")
        rows = d.get("rows", [])
        if not isinstance(rows, list) or not rows:
            findings.append(f"bench: {p.name} has no rows")
            continue
        for i, row in enumerate(rows):
            rmissing = BENCH_ROW_KEYS - set(row)
            if rmissing:
                findings.append(
                    f"bench: {p.name} row {i} missing {sorted(rmissing)}")
                break
            if not isinstance(row["us_per_call"], (int, float)):
                findings.append(
                    f"bench: {p.name} row {i} us_per_call not numeric")
                break
        _print(f"  bench-schema {p.name}: {len(rows)} rows")
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="wave-safety static analysis for the AAM pipeline")
    ap.add_argument("--module", action="append", default=[],
                    help="additionally lint a module's LINT_* surfaces "
                         "(repeatable)")
    ap.add_argument("--bench-schema", action="store_true",
                    help="also validate BENCH_*.json trajectory files")
    ap.add_argument("--skip-waverace", action="store_true",
                    help="skip the race pass — for quick keyspace/algebra "
                         "iterations")
    ap.add_argument("--trace-off-clean", action="store_true",
                    help="prove tracing off records nothing + "
                         "schema-smoke trace/metrics JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the recorded rounds run (default cuda)")
    ap.add_argument("--backend", default="atomic", choices=BACKENDS,
                    help="the commit tier of the race pass (default "
                         "atomic)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    spec = CommitSpec(backend=args.backend, stats=False)

    findings: list[str] = []
    _print("aamlint: algebra")
    findings += run_algebra()
    _print("aamlint: keyspace")
    findings += run_keyspace()
    if not args.skip_waverace:
        _print(f"aamlint: waverace ({args.backend} on {device})")
        findings += run_waverace(spec=spec, device=device)
    for modname in args.module:
        _print(f"aamlint: module {modname}")
        findings += run_module(modname, spec=spec, device=device)
    if args.bench_schema:
        _print("aamlint: bench-schema")
        findings += run_bench_schema()
    if args.trace_off_clean:
        _print("aamlint: trace-off-clean")
        findings += run_trace_off_clean(device=device)

    if findings:
        _print(f"\naamlint: {len(findings)} finding(s)")
        for f in findings:
            _print(f"  FINDING: {f}")
        return 1
    _print("\naamlint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
