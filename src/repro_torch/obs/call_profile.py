"""What one call of each kernel wrapper costs its caller, on one card.

    PYTHONPATH=src python3 -m repro_torch.obs.call_profile

For each of the four kernel wrappers, at the main path's sizes and at a
tiny size where the host's work is the whole call:

* call ms — one call bracketed by an event pair after a synchronise,
  median of 50 (the card waits while the host checks the arguments,
  dispatches and launches, so this is what a caller pays per call);
* device ms — :func:`repro_torch.obs.timing.device_ms` (20 calls back to
  back, median of 3 windows).

The sizes: the commits at V = 2**21 and N = 63,536,636 messages (a BFS
round of ``chip_smoke.py``'s scale-21 graph; uniform random targets, not
the graph's) and at V = N = 1,024; the bucket count on the same N into
one bucket (the engine at world size 1) and on phi3.5-moe's 16,384 owner
ids into 16 buckets; the SSD chunk at one mamba2-780m prefill layer's
G = 6,144 cells (L 128, N 128, P 64, f32) and at one cell of 16 x 16.

It uses only the wrappers' names and keywords, which every version of
the port since the kernels were ported has, so it times an older
checkout too: put that checkout's ``src`` first and run the file by path,
e.g. ``PYTHONPATH=old/src python3 -c "import runpy;
runpy.run_path('src/repro_torch/obs/call_profile.py',
run_name='__main__')"``.  The first line names the package it timed and
whether its kernels are dispatched ops.  Needs a CUDA device.
"""
from __future__ import annotations

import statistics
import subprocess
import sys

REPS = 50
V_MAIN, N_MAIN = 1 << 21, 63_536_636
SSD_MAIN = (6144, 128, 128, 64)          # G, L, N, P
SSD_TINY = (1, 16, 16, 16)


def call_ms(fn, reps: int = REPS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _cases(device):
    import torch
    from repro_torch.kernels.coalesce import bucket_count_kernel
    from repro_torch.kernels.coarse_commit import coarse_commit_kernel
    from repro_torch.kernels.fused_wave import fused_route_commit_kernel
    from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
    gen = torch.Generator(device=device).manual_seed(0)

    def commit_args(v, n, dtype):
        state = torch.zeros(v, dtype=dtype, device=device)
        idx = torch.randint(0, v, (n,), generator=gen, device=device,
                            dtype=torch.int32)
        val = torch.rand(n, generator=gen, device=device).mul(100).to(dtype)
        return state, idx, val

    def ssd_args(g, L, n, p):
        C, B = (torch.randn(g, L, n, generator=gen, device=device)
                for _ in range(2))
        x = torch.randn(g, L, p, generator=gen, device=device)
        a = -torch.rand(g, L, generator=gen, device=device) * (250 / L)
        return C, B, x, a

    out = []
    for label, v, n in (("main", V_MAIN, N_MAIN), ("tiny", 1024, 1024)):
        s, i, x = commit_args(v, n, torch.float32)
        out.append((f"coarse_commit add/f32 {label} V={v} N={n}",
                    lambda s=s, i=i, x=x: coarse_commit_kernel(
                        s, i, x, op="add")))
        s, i, x = commit_args(v, n, torch.int32)
        out.append((f"fused_route_commit min/i32 {label} V={v} N={n}",
                    lambda s=s, i=i, x=x: fused_route_commit_kernel(
                        s, i, x, op="min")))
    for n, b in ((N_MAIN, 1), (16384, 16), (1024, 16)):
        owner = torch.randint(0, b, (n,), generator=gen, device=device,
                              dtype=torch.int32)
        out.append((f"bucket_count N={n} buckets={b}",
                    lambda o=owner, b=b: bucket_count_kernel(o, b)))
    for shape in (SSD_MAIN, SSD_TINY):
        args = ssd_args(*shape)
        out.append((f"ssd_chunk f32 G,L,N,P={shape}",
                    lambda args=args: ssd_chunk_kernel(*args)))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("call_profile: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.obs.timing import device_ms
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    device = torch.device("cuda")
    cases = _cases(device)
    ops = hasattr(torch.ops.repro_torch, "coarse_commit")
    print(f"package {repro_torch.__file__}; kernels as dispatched ops: "
          f"{ops}; torch {torch.__version__}")
    for name, fn in cases:
        call = call_ms(fn)
        dev = device_ms(fn)
        print(f"  {name}: call {call:.4f} ms (median of {REPS}), device "
              f"{dev:.4f} ms, call - device {call - dev:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
