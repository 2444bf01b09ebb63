"""Where Mamba2 serving's device time goes: ``torch.profiler`` over a
prefill and decode steps of mamba2-780m at its published width on one
card.

    PYTHONPATH=src python3 -m repro_torch.obs.serve_profile

Draws the model's weights on the card from seed 0 (as ``chip_smoke.py``
phase 7 does), then profiles one prefill of 8 x 2048 prompt tokens and a
run of 8 greedy decode steps from its cache, bf16 compute, on the SSD
kernel's path, each after one warm-up run.  Prints the card, each run's
wall time, the device's busy share (the sum of kernel times over the wall
time), the kernels that took most of the device time and the device time
by step (the SSD kernel, GEMMs, copies and casts, the rest: elementwise
passes, reductions, the einsums' own kernels).  Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys

from repro_torch.obs.round_profile import profile_runs

ARCH = "mamba2-780m"
PROMPT = (8, 2048)               # batch x prompt tokens, as in chip_smoke
DECODE_STEPS = 8
STEPS = (("SSD kernel", ("ssd_chunk_kernel",)),
         ("GEMMs", ("gemm", "gemv", "nvjet", "xmma", "cutlass")),
         ("copies/casts", ("copy", "Memcpy", "Memset")))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import model as M
    from repro_torch.serve.serve_step import pad_cache

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    cfg = ARCHS[ARCH]
    b, s = PROMPT
    rcfg = RunConfig(model=cfg, shape=ShapeConfig(
        "serve", s + DECODE_STEPS, b, "decode"), use_pallas=True)
    model = M.init(cfg, 0, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(0))
    logits, cache = M.prefill(cfg, rcfg, model, {"tokens": tokens})
    cache = pad_cache(cfg, cache, s + DECODE_STEPS)
    first = logits.argmax(-1).to(torch.int32)

    def decode():
        c, tok = cache, first
        for i in range(DECODE_STEPS):
            lg, c = M.decode_step(cfg, rcfg, model, c, tok, s + i)
            tok = lg.argmax(-1).to(torch.int32)
        return DECODE_STEPS

    label = f"{ARCH}, {b} x {s} tokens, {rcfg.compute_dtype}, kernel path"
    profile_runs({"prefill": lambda: (
        M.prefill(cfg, rcfg, model, {"tokens": tokens}), 1)[1]},
        f"{label}; the count is prefills", steps=STEPS)
    profile_runs({"decode": decode},
                 f"{label}; the count is decode steps", steps=STEPS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
