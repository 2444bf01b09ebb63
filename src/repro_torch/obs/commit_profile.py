"""Where a commit kernel's time goes: device ms per launch of both commit
kernels on the main path's batch and on batches that each take one cost
away, on one card.

    PYTHONPATH=src python3 -m repro_torch.obs.commit_profile

Builds the Graph500 Kronecker graph of ``chip_smoke.py`` (scale 21, edge
factor 16, seed 0) and times, beside ``scatter_reduce_`` on the same
batch:

(a) a read-only pass over ``idx`` and ``val`` (``val.sum()`` and the sum
    of ``idx``'s bits read as f32, since PyTorch's int32 sum reads at a
    third of the rate): the rate at which the card reads the 8N bytes
    that every commit reads;
(b) the commit kernels on the PageRank batch: ``g.dst``, f32 ``add``
    (N = E messages, V = 2**21);
(c) the same N messages with targets drawn uniformly over V: as many
    atomics, no hot target;
(d) the same N messages with ``g.dst`` sorted: each target's messages
    side by side, dense sectors;
(e) the int32 ``min`` batch of the largest round of a ``pallas`` BFS from
    the vertex of highest degree: masked messages, and the skip of
    atomics that a stale read shows cannot change the state;
(f) the N messages of (b) with targets drawn uniformly from 4,096: all
    but a few combine in the CTAs' tables, so N over the time is the
    rate at which the kernel pushes messages through shared-memory
    atomics.

Then the ``-Xptxas -v`` report of each commit library: registers, shared
memory and spills of every kernel instance.  Device ms are taken as
:func:`repro_torch.obs.timing.device_ms` says.  Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys

from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_PER_S
from repro_torch.obs.timing import REPS, WINDOWS, device_ms

SCALE = 21


def largest_bfs_round(g, src: int):
    """(state, idx, val) of the BFS round whose commit has the most valid
    messages, as the ``pallas`` tier hands them to its kernel.  BFS
    advances one level per round, so the round that reads level l holds
    the distances up to l and sends ``dist + 1`` along every out-edge of
    the vertices at distance l; its batch follows from the final
    distances."""
    import torch
    from repro_torch.core.commit import CommitSpec
    from repro_torch.graphs.algorithms.bfs import INF, bfs
    dist = bfs(g, src, spec=CommitSpec(backend="pallas", stats=False)).dist
    reached = dist < INF
    level_of = dist[reached].long()
    sent = torch.zeros(int(level_of.max()) + 1, dtype=torch.int64,
                       device=dist.device).index_add_(
        0, level_of, g.degrees[reached].long())
    level = int(torch.argmax(sent))
    state = torch.where(dist <= level, dist, INF)
    before = state[g.src.long()]
    idx = torch.where(before == level, g.dst, -1).to(torch.int32)
    return state, idx, before + 1


def ptxas_lines(report: str):
    """(kernel, what ptxas used) for each kernel instance of a report,
    names demangled where ``cu++filt`` or ``c++filt`` is found."""
    names, out = [], []
    for line in report.splitlines():
        if "Compiling entry function" in line:
            names.append(line.split("'")[1])
            out.append("")
        elif names and ("Used" in line or "spill" in line):
            part = line.split(":", 1)[-1].strip()
            out[-1] = f"{out[-1]}; {part}" if out[-1] else part
    for tool in ("cu++filt", "c++filt"):
        try:
            names = subprocess.run([tool], input="\n".join(names),
                                   capture_output=True, text=True,
                                   check=True, timeout=60).stdout.split("\n")
            break
        except (OSError, subprocess.SubprocessError):
            continue
    return list(zip(names, out))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("commit_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.graphs.generators import kronecker
    from repro_torch.kernels import _build
    from repro_torch.kernels.coarse_commit import coarse_commit_kernel
    from repro_torch.kernels.fused_wave import fused_route_commit_kernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    g = kronecker(SCALE, 16, seed=0, device="cuda")
    v, n = g.num_vertices, g.num_edges
    gen = torch.Generator(device="cuda").manual_seed(0)
    val = torch.randint(-50, 50, (n,), generator=gen, device="cuda") / 8.0
    state = torch.randint(-50, 50, (v,), generator=gen,
                          device="cuda").float()
    idx = g.dst
    bits = idx.view(torch.float32)
    floor = device_ms(lambda: (bits.sum(), val.sum()))
    print(f"commit_profile: scale {SCALE}, N={n}, V={v}; device ms per "
          f"launch, {REPS} launches back to back, median of {WINDOWS} "
          f"windows")
    print(f"(a) read idx and val once (two f32 sums): {floor:.4f} "
          f"ms, {8 * n / floor / 1e9:.3f} TB/s; (8N + 8V) bytes / 3.35 "
          f"TB/s = {(8 * n + 8 * v) / HBM_BYTES_PER_S * 1e3:.4f} ms")
    batches = {
        "(b) g.dst, f32 add": ("add", state, idx, val),
        "(c) uniform targets, f32 add": ("add", state, torch.randint(
            0, v, (n,), generator=gen, device="cuda", dtype=torch.int32),
            val),
        "(d) sorted g.dst, f32 add": ("add", state, torch.sort(idx).values,
                                      val),
    }
    src = int(torch.argmax(g.degrees))
    b_state, b_idx, b_val = largest_bfs_round(g, src)
    valid = int((b_idx >= 0).sum())
    bfs_label = (f"(e) largest BFS round, i32 min, {valid} of {n} valid "
                 f"({valid / n:.3f})")
    batches[bfs_label] = ("min", b_state, b_idx, b_val)
    batches["(f) 4,096 targets, f32 add"] = ("add", state, torch.randint(
        0, 4096, (n,), generator=gen, device="cuda", dtype=torch.int32), val)
    for label, (op, st, ix, vl) in batches.items():
        # masked messages (-1) go to a sentinel row V, as in the plain version
        wide = torch.where(ix >= 0, ix, v).long()
        reduce = "sum" if op == "add" else "amin"
        buf = torch.cat([st, st.new_zeros(1)])
        coarse = device_ms(lambda: coarse_commit_kernel(st, ix, vl, op=op))
        fused = device_ms(lambda: fused_route_commit_kernel(st, ix, vl,
                                                            op=op))
        library = device_ms(lambda: buf.scatter_reduce_(0, wide, vl, reduce))
        print(f"{label}: coarse_commit {coarse:.4f} ms  fused_route_commit "
              f"{fused:.4f} ms  scatter_reduce_ {library:.4f} ms; "
              f"{n / coarse / 1e6:.1f} G messages/s through coarse_commit")
        del wide, buf
    for name in ("coarse_commit", "fused_wave"):
        print(f"ptxas, csrc/{name}.cu:")
        for kernel, used in ptxas_lines(_build.ptxas_report(name)):
            print(f"  {kernel}: {used}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
