"""Distributed PageRank + BFS over 8 shards on the PyTorch/CUDA port (the
paper's §6.2 scenario): coalesced accumulate waves over all-to-all, with
sub-round requeue.  The port of ``examples/distributed_pagerank.py``.

The reference re-execs itself with 8 forced host devices; this script
spawns 8 gloo ranks that share the device (``--device``, default
``cuda``; ``cpu`` runs on the CPU), and rank 0 prints.

  PYTHONPATH=src python examples_torch/distributed_pagerank.py
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.engine import distributed_bfs, distributed_pagerank
from repro_torch.graphs.algorithms.bfs import bfs_reference
from repro_torch.graphs.algorithms.pagerank import pagerank_reference
from repro_torch.graphs.generators import kronecker
from repro_torch.launch.mesh import spawn_ranks

WORLD = 8


def shard(mesh):
    """One rank of the run; rank 0 checks and prints."""
    g = kronecker(scale=13, edge_factor=8, seed=5, device=mesh.device)
    src = int(torch.argmax(g.degrees))
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say(f"{mesh.size}-shard mesh; graph |V|={g.num_vertices} "
        f"|E|={g.num_edges}", flush=True)

    t0 = time.perf_counter()
    dist, rounds = distributed_bfs(mesh, g, src, capacity=8192)
    dt = time.perf_counter() - t0
    if mesh.rank == 0:
        ok = np.array_equal(dist.cpu().numpy().astype(np.int64),
                            bfs_reference(g, src))
        say(f"distributed BFS : {dt*1e3:7.1f} ms rounds={int(rounds)} "
            f"correct={ok}", flush=True)
        assert ok

    t0 = time.perf_counter()
    pr = distributed_pagerank(mesh, g, iters=10, capacity=8192)
    dt = time.perf_counter() - t0
    if mesh.rank == 0:
        err = float(np.abs(pr.cpu().numpy()
                           - pagerank_reference(g, iters=10)).max())
        say(f"distributed PR  : {dt*1e3:7.1f} ms max|err|={err:.2e}",
            flush=True)
        assert err <= 2e-4


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    print(f"ranks: {WORLD} gloo processes on {dev} (world size {WORLD})",
          flush=True)
    spawn_ranks(shard, WORLD, device=dev)


if __name__ == "__main__":
    main()
