"""Where a round's device time goes: ``torch.profiler`` over the graph
algorithms of the PyTorch port on one card.

    PYTHONPATH=src python3 -m repro_torch.obs.round_profile

Builds the Graph500 Kronecker graph of ``chip_smoke.py`` (scale 21, edge
factor 16, seed 0), runs one warm-up and one profiled call of each
single-shard algorithm (BFS, PageRank, st-connectivity to the farthest
vertex BFS reaches, coloring, Boruvka on random weights) on the
``pallas``, ``atomic`` and ``coarse`` backends, and of one wave of the
wave engine on ``pallas`` and
``fused``: ``wave_until_delivered`` on a PageRank iteration's messages
(every edge, f32 ``add``) at world size 1 and capacity 2**24, as in
``chip_smoke.py`` phase 6 but without the call's set-up (the edge
partition).  Prints the card, each run's wall time, the device's busy
share (the sum of kernel times over the wall time), the kernels that
took most of the device time and, for the wave, the device time by
step (argsort, count, scatter/gather, commit, copies and casts, the
rest).  Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys
import time

SCALE = 21
BACKENDS = ("pallas", "atomic", "coarse")
ENGINE_BACKENDS = ("pallas", "fused")
ENGINE_CAPACITY = 2 ** 24
TOP = 12                      # kernels listed per run
# device time of a wave by step: (step, substrings of its kernels' names)
STEPS = (("argsort", ("RadixSort", "radix_sort", "Radix")),
         ("count", ("count_kernel",)),
         ("commit", ("aam",)),
         ("scatter/gather", ("index_elementwise", "index_put", "scatter",
                             "gather")),
         ("copies/casts", ("Memcpy", "Memset", "copy")))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("round_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.commit import CommitSpec
    from repro_torch.graphs.algorithms.bfs import bfs
    from repro_torch.graphs.algorithms.boruvka import boruvka
    from repro_torch.graphs.algorithms.coloring import coloring
    from repro_torch.graphs.algorithms.pagerank import pagerank
    from repro_torch.graphs.algorithms.stconn import st_connectivity
    from repro_torch.core.engine import EngineConfig, wave_until_delivered
    from repro_torch.graphs.generators import kronecker, random_weights
    from repro_torch.launch.mesh import make_mesh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    g = kronecker(SCALE, 16, seed=0, device="cuda")
    gw = random_weights(g, seed=0)
    src = int(torch.argmax(g.degrees))
    dist = bfs(g, src, spec=CommitSpec(backend="pallas", stats=False)).dist
    far = int(torch.argmax(torch.where(dist < 2 ** 29, dist, -1)))
    for backend in BACKENDS:
        spec = CommitSpec(backend=backend, stats=False)
        profile_runs(
            {"bfs": lambda: bfs(g, src, spec=spec).rounds,
             "pagerank": lambda: (pagerank(g, iters=20, spec=spec), 20)[1],
             "st_connectivity": lambda: st_connectivity(g, src, far,
                                                        spec=spec)[1],
             "coloring": lambda: coloring(g, seed=0, spec=spec)[1],
             "boruvka": lambda: boruvka(gw, spec=spec)[3]},
            f"{backend}, scale {SCALE}")
    v = g.num_vertices
    contrib = torch.rand(g.num_edges, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    valid = torch.ones(g.num_edges, dtype=torch.bool, device="cuda")
    for backend in ENGINE_BACKENDS:
        ecfg = EngineConfig(make_mesh(device="cuda"), v, ENGINE_CAPACITY,
                            op="add",
                            spec=CommitSpec(backend=backend, stats=False))
        profile_runs(
            {"wave_until_delivered": lambda: wave_until_delivered(
                ecfg, torch.zeros(v, device="cuda"), g.dst, contrib,
                valid)[3]},
            f"engine, one PageRank wave, world size 1, C = 2^24, {backend}, "
            f"scale {SCALE}; the count is sub-rounds", steps=STEPS)
    return 0


def profile_runs(runs, label, steps=()):
    """Profile each ``run`` (a callable returning its count of rounds)
    after one warm-up call; ``steps`` groups device time by
    ``(step, substrings of its kernels' names)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rounds = run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_time_total > 0 and e.device_type.name == "CUDA"]
        if not events:
            print(f"{name} ({label}): the trace holds no device time")
            continue
        device = sum(e.device_time_total for e in events) / 1e3
        print(f"{name} ({label}): {rounds} "
              f"rounds, wall {wall:.3f} ms ({wall / rounds:.3f} ms/round), "
              f"device kernels {device:.3f} ms, busy share "
              f"{device / wall:.3f}")
        for e in sorted(events, key=lambda e: -e.device_time_total)[:TOP]:
            print(f"  {e.device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
                  f"{e.key[:90]}")
        if steps:
            by_step = {}
            for e in events:
                step = next((name for name, keys in steps
                             if any(k in e.key for k in keys)), "the rest")
                by_step[step] = by_step.get(step, 0) + e.device_time_total
            print("  by step: " + ", ".join(
                f"{name} {t / 1e3:.3f} ms" for name, t in sorted(
                    by_step.items(), key=lambda kv: -kv[1])))


if __name__ == "__main__":
    sys.exit(main())
