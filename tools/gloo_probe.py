"""Which ``torch.distributed`` collectives gloo runs on CUDA tensors.

    PYTHONPATH=src python3 tools/gloo_probe.py [--world 2,8]

The wave engine and the parallel layouts run their ranks as gloo
processes that share one card (NCCL puts one rank on a card).  gloo
takes a CUDA tensor through host memory for some collectives and not
for others: under torch 2.11 an all-gather of CUDA tensors kills the
process.  For each world size this spawns that many gloo ranks on
``cuda:0`` and runs each collective of :data:`PROBES` on CUDA tensors
(int32, float32 and uint8, as the engine sends them), each rank checking
the values against what the collective means.  A rank that dies ends
that set of ranks; the probe reports the collective it died in, with the
exit code, and starts a fresh set at the next one.  One line a
collective and world size: ``ok``, ``wrong values``, ``raised: ...``,
``died (exit code)`` or ``hung``.  ``--device cpu`` runs the same
probes on CPU tensors, the baseline every collective passes.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import pathlib
import socket
import sys
import tempfile
import time

N = 12                       # elements a rank sends to each peer
STEP_TIMEOUT_S = 60          # a collective that takes longer is "hung"

PROBES = ("all_reduce", "broadcast", "all_to_all_single", "new_group",
          "broadcast_object_list", "funcol_all_reduce",
          "reduce_scatter_tensor", "funcol_reduce_scatter_tensor",
          "all_gather_into_tensor", "funcol_all_gather_tensor",
          "all_gather")


def _inputs(rank, world, dtype, device):
    """Rank ``rank``'s [world, N] tensor: row p holds what goes to rank p."""
    import torch
    x = torch.arange(world * N, device=device).reshape(world, N)
    return ((x + 100 * rank) % 251).to(dtype)


def _probe(name, rank, world, device):
    """Run one collective on CUDA tensors; True when every dtype's result
    equals its meaning."""
    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    ok = True
    for dtype in (torch.int32, torch.float32, torch.uint8):
        if dtype == torch.uint8 and name not in ("all_to_all_single",
                                                 "all_gather"):
            continue
        x = _inputs(rank, world, dtype, device)
        every = torch.stack([_inputs(r, world, dtype, "cpu")
                             for r in range(world)])        # [src, dst, N]
        if name == "all_reduce":
            got, want = x.clone(), every.sum(0).to(dtype)
            dist.all_reduce(got)
        elif name == "funcol_all_reduce":
            got = torch.ops._c10d_functional.wait_tensor(
                funcol.all_reduce(x, "sum", dist.group.WORLD))
            want = every.sum(0).to(dtype)
        elif name == "broadcast":
            got = x.clone()
            dist.broadcast(got, src=0)
            want = every[0]
        elif name == "all_to_all_single":
            got = torch.empty_like(x)
            dist.all_to_all_single(got, x)
            want = every[:, rank]
        elif name == "new_group":
            group = dist.new_group(list(range(world - 1)) if world > 2
                                   else list(range(world)))
            members = dist.get_process_group_ranks(group)
            got = x.clone()
            if rank in members:
                dist.all_reduce(got, group=group)
                want = every[members].sum(0).to(dtype)
            else:
                want = x.cpu()
        elif name == "broadcast_object_list":
            box = [{"rank": rank, "t": x.cpu()}] if rank == 0 else [None]
            dist.broadcast_object_list(box, src=0)
            got, want = box[0]["t"], every[0]
        elif name == "reduce_scatter_tensor":
            got = torch.empty_like(x[0])
            dist.reduce_scatter_tensor(got, x.reshape(-1))
            want = every.sum(0)[rank].to(dtype)
        elif name == "funcol_reduce_scatter_tensor":
            got = torch.ops._c10d_functional.wait_tensor(
                funcol.reduce_scatter_tensor(x.reshape(-1), "sum", 0,
                                             dist.group.WORLD))
            want = every.sum(0)[rank].to(dtype)
        elif name == "all_gather_into_tensor":
            got = torch.empty((world * world, N), dtype=dtype,
                              device=device)
            dist.all_gather_into_tensor(got, x)
            want = every.reshape(world * world, N)
        elif name == "funcol_all_gather_tensor":
            got = torch.ops._c10d_functional.wait_tensor(
                funcol.all_gather_tensor(x, 0, dist.group.WORLD))
            want = every.reshape(world * world, N)
        elif name == "all_gather":
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            got, want = torch.stack(parts), every
        else:
            raise ValueError(name)
        ok &= bool(torch.equal(got.cpu(), want.cpu()))
    return ok


def _rank(rank, world, port, start, log_dir, device):
    import warnings
    import torch
    import torch.distributed as dist
    warnings.filterwarnings("ignore", category=FutureWarning)
    torch.set_num_threads(1)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=STEP_TIMEOUT_S))
    log = pathlib.Path(log_dir) / f"rank{rank}.jsonl"
    try:
        for i in range(start, len(PROBES)):
            with open(log, "a") as fh:
                fh.write(json.dumps({"i": i, "began": True}) + "\n")
            try:
                res = "ok" if _probe(PROBES[i], rank, world, device) \
                    else "wrong values"
            except Exception as e:   # noqa: BLE001 — what the probe reports
                res = f"raised: {type(e).__name__}: {str(e)[:200]}"
            if device.type == "cuda":
                torch.cuda.synchronize()
            with open(log, "a") as fh:
                fh.write(json.dumps({"i": i, "result": res}) + "\n")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _records(log_dir, world):
    out = []
    for r in range(world):
        path = pathlib.Path(log_dir) / f"rank{r}.jsonl"
        out.append([json.loads(line) for line in path.read_text()
                    .splitlines()] if path.exists() else [])
    return out


def probe_world(world: int, device: str = "cuda:0") -> dict:
    """``{collective: result}`` for ``world`` gloo ranks on ``device``."""
    import torch.multiprocessing as mp
    results, start = {}, 0
    ctx = mp.get_context("spawn")
    while start < len(PROBES):
        with tempfile.TemporaryDirectory() as log_dir:
            port = _free_port()
            procs = [ctx.Process(target=_rank, args=(
                r, world, port, start, log_dir, device))
                for r in range(world)]
            for p in procs:
                p.start()
            deadline = time.monotonic() + 120 + STEP_TIMEOUT_S * (
                len(PROBES) - start)
            try:
                while any(p.is_alive() for p in procs):
                    if any(p.exitcode not in (None, 0) for p in procs) or \
                            time.monotonic() > deadline:
                        break
                    time.sleep(0.2)
                time.sleep(1.0)       # let the others write their line
            finally:
                for p in procs:
                    if p.is_alive():
                        p.kill()
                    p.join(10)
            logs = _records(log_dir, world)
        done = [{rec["i"]: rec["result"] for rec in recs if "result" in rec}
                for recs in logs]
        for i in range(start, len(PROBES)):
            if all(i in d for d in done):
                results[PROBES[i]] = " / ".join(sorted({d[i] for d in done}))
                continue
            codes = sorted({p.exitcode for p in procs
                            if p.exitcode not in (None, 0)})
            results[PROBES[i]] = (f"died (exit code {codes})" if codes
                                  else "hung")
            start = i + 1
            break
        else:
            start = len(PROBES)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", default="2,8",
                    help="comma-separated world sizes")
    ap.add_argument("--device", default="cuda:0",
                    help="where the ranks' tensors lie (cpu: the baseline)")
    args = ap.parse_args(argv)
    import torch
    from repro_torch import resolve_device
    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"torch {torch.__version__}, {name}; gloo ranks sharing "
          f"{device}", flush=True)
    for world in (int(w) for w in args.world.split(",")):
        for name, res in probe_world(world, str(device)).items():
            print(f"gloo_probe: world {world}: {name:30s} {res}", flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
