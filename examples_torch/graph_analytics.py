"""All six paper case-studies (§3.3) on the AAM engine of the PyTorch/CUDA
port, with telemetry.  The port of ``examples/graph_analytics.py``.

  PYTHONPATH=src python examples_torch/graph_analytics.py
  PYTHONPATH=src python examples_torch/graph_analytics.py --distributed
    # also runs all six algorithms through the shared run_distributed
    # harness (§6.2) on 8 gloo ranks sharing the device (the reference
    # re-execs itself with 8 forced host devices instead)

``--device cpu`` runs on the CPU (the default, ``cuda``, raises without a
card).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.commit import CommitSpec
from repro_torch.graphs.algorithms.bfs import bfs, distributed_bfs
from repro_torch.graphs.algorithms.boruvka import (boruvka,
                                                    distributed_boruvka,
                                                    mst_reference)
from repro_torch.graphs.algorithms.coloring import (coloring,
                                                     distributed_coloring,
                                                     validate_coloring)
from repro_torch.graphs.algorithms.pagerank import (distributed_pagerank,
                                                     pagerank)
from repro_torch.graphs.algorithms.sssp import distributed_sssp, sssp
from repro_torch.graphs.algorithms.stconn import (distributed_stconn,
                                                   st_connectivity)
from repro_torch.graphs.generators import (erdos_renyi, kronecker,
                                           random_weights)
from repro_torch.launch.mesh import spawn_ranks

WORLD = 8


def run(name, msg_type, fn):
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    print(f"{name:18s} [{msg_type}]  {dt*1e3:8.1f} ms   {out}", flush=True)


def single_shard(dev):
    g = kronecker(scale=13, edge_factor=16, seed=1, device=dev)
    gw = random_weights(g, seed=2)
    src = int(torch.argmax(g.degrees))
    far = int(np.argsort(g.degrees.cpu().numpy())[-2])
    print(f"Kronecker graph |V|={g.num_vertices} |E|={g.num_edges}\n")

    run("BFS", "FF&MF", lambda: (lambda r:
        f"rounds={int(r.rounds)} conflicts={int(r.conflicts)}")(
        bfs(g, src, spec=CommitSpec(backend="coarse", m=4096,
                                    stats=False))))
    run("BFS (auto-tuned)", "FF&MF", lambda: (lambda r:
        f"rounds={int(r.rounds)} conflicts={int(r.conflicts)} "
        f"(calibrated backend+M, conflict-feedback sizing)")(
        bfs(g, src, spec=CommitSpec(backend="auto", stats=False))))
    run("PageRank", "FF&AS", lambda: (lambda r:
        f"sum={float(r[0].sum()):.4f} conflicting-accs={int(r[1])}")(
        pagerank(g, iters=20)))
    run("SSSP", "FF&MF", lambda: (lambda d, rr:
        f"rounds={int(rr)} reached={int((d < 1e38).sum())}")(
        *sssp(gw, src)))
    run("ST-connectivity", "FR&AS", lambda: (lambda f, r:
        f"connected={bool(f)} rounds={int(r)}")(
        *st_connectivity(g, src, far)))
    run("Boman coloring", "FR&MF", lambda: (lambda c, r, failed:
        f"colors={int(c.max())+1} rounds={int(r)} "
        f"valid={validate_coloring(g, c)}")(
        *coloring(g, seed=0)))
    gw_small = random_weights(erdos_renyi(2000, 8.0, seed=3, device=dev),
                              seed=4)
    run("Boruvka MST", "FR&MF", lambda: (lambda comp, w, ne, r:
        f"weight={float(w):.1f} (ref {mst_reference(gw_small):.1f}) "
        f"edges={int(ne)} rounds={int(r)}")(
        *boruvka(gw_small)))


def distributed(mesh):
    """One rank of the 8-shard run; rank 0 prints."""
    dev = mesh.device
    gd = kronecker(scale=10, edge_factor=8, seed=1, device=dev)
    gdw = random_weights(gd, seed=2)
    sd = int(torch.argmax(gd.degrees))
    fd = int(np.argsort(gd.degrees.cpu().numpy())[-2])
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say(f"\n{mesh.size}-shard run_distributed harness; "
        f"|V|={gd.num_vertices} |E|={gd.num_edges}", flush=True)

    def rund(name, msg_type, fn):
        t0 = time.perf_counter()
        out, res = fn()
        dt = time.perf_counter() - t0
        say(f"{name:18s} [{msg_type}]  {dt*1e3:8.1f} ms   {out}  "
            f"rounds={int(res.rounds)} conflicts={int(res.conflicts)} "
            f"subrounds={int(res.subrounds)} "
            f"delivered_all={bool(res.delivered_all)}", flush=True)
        assert res.delivered_all and "valid=False" not in out

    rund("BFS", "FF&MF", lambda: (lambda d, ro, r:
        (f"reached={int((d < 2**30).sum())}", r))(
        *distributed_bfs(mesh, gd, sd, capacity=2048, telemetry=True)))
    rund("PageRank", "FF&AS", lambda: (lambda pr, r:
        (f"sum={float(pr.sum()):.4f}", r))(
        *distributed_pagerank(mesh, gd, iters=10, capacity=2048,
                              telemetry=True)))
    rund("SSSP", "FF&MF", lambda: (lambda d, ro, r:
        (f"reached={int((d < 1e38).sum())}", r))(
        *distributed_sssp(mesh, gdw, sd, capacity=2048, telemetry=True)))
    rund("ST-connectivity", "FR&AS", lambda: (lambda f, ro, r:
        (f"connected={bool(f)}", r))(
        *distributed_stconn(mesh, gd, sd, fd, capacity=2048,
                            telemetry=True)))
    rund("Boman coloring", "FR&MF", lambda: (lambda c, ro, nc, r:
        (f"colors={int(c.max())+1} "
         f"valid={validate_coloring(gd, c)}", r))(
        *distributed_coloring(mesh, gd, seed=0, capacity=2048,
                              telemetry=True)))
    rund("Boruvka MST", "FR&MF", lambda: (lambda comp, w, ne, ro, r:
        (f"weight={float(w):.1f} edges={int(ne)}", r))(
        *distributed_boruvka(mesh, gdw, capacity=2048, telemetry=True)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--distributed", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    single_shard(dev)
    if args.distributed:
        print(f"ranks: {WORLD} gloo processes on {dev} "
              f"(world size {WORLD})", flush=True)
        spawn_ranks(distributed, WORLD, device=dev)


if __name__ == "__main__":
    main()
