"""Where a train step's device time goes: ``torch.profiler`` over one
``make_train_step`` step of one architecture at its published width on
one card.

    PYTHONPATH=src python3 -m repro_torch.obs.train_profile
    PYTHONPATH=src python3 -m repro_torch.obs.train_profile \\
        --arch qwen2-1.5b --layers 28 --microbatches 2

The defaults are ``chip_smoke.py`` phase 12a's cell: phi3.5-moe-42b-a6.6b
cut to 2 layers (``--layers`` cuts the depth, never the width), bf16
compute, ``remat="full"``, AdamW at the reference's defaults, f32 weights
drawn on the card from seed 0.  Every run trains on phase 12's 4 x 2048
``TokenStream(seed=0)`` tokens (:data:`BATCH`).
After two warm-up steps it prints the card, the step's wall time, the
device's busy share, the kernels that took most of the device time and
the device time by kernel class (GEMMs, copies and casts, the
bucket-count kernel, the rest); then, from CUDA events around the
model's own functions in one more step, the device time by step (MoE
routing, the dispatch's plan and scatter, the expert FFNs, the combine,
the attention core, each in the forward and again in remat's recompute;
the backward's own kernels, the clip and the optimizer are "the rest")
and the peak memory.  ``chip_smoke.py`` phase 12 times the step's three
parts (loss and gradients, clip, AdamW) apart.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

from repro_torch.obs.round_profile import profile_runs
from repro_torch.obs.serve_profile import time_by_step

BATCH = (4, 2048)        # chip_smoke.py's TRAIN_BATCH: batch x sequence
STEPS = (("GEMMs", ("gemm", "gemv", "nvjet", "xmma", "cutlass")),
         ("bucket-count kernel", ("aam_bucket_count", "bucket_count")),
         ("copies/casts", ("copy", "Memcpy", "Memset")))


def main(argv=None) -> int:
    import torch
    from repro_torch.configs.archs import ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS),
                    default="phi3.5-moe-42b-a6.6b")
    ap.add_argument("--layers", type=int, default=2,
                    help="cut the depth to this many layers")
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    cfg = dataclasses.replace(ARCHS[args.arch], num_layers=args.layers)
    batch_size, seq = BATCH
    rcfg = RunConfig(model=cfg, shape=ShapeConfig(
        "train", seq, batch_size, "train"), remat="full",
        microbatches=args.microbatches)
    t0 = time.perf_counter()
    model, params, opt_state = init_train_state(cfg, rcfg, device="cuda")
    step_fn = make_train_step(cfg, rcfg, model)
    batch = TokenStream(cfg, rcfg.shape, seed=0).tensors(0, device="cuda")
    state = {"params": params, "opt": opt_state, "step": 0}

    def step():
        p, o, _ = step_fn(state["params"], state["opt"], state["step"], batch)
        state.update(params=p, opt=o, step=state["step"] + 1)
        return 1
    step()
    torch.cuda.synchronize()
    print(f"{args.arch}: {cfg.num_layers} layers, weights drawn and the "
          f"first step in {time.perf_counter() - t0:.1f} s")

    label = (f"{args.arch}, {cfg.num_layers} layers, {batch_size} x "
             f"{seq} tokens, microbatches {args.microbatches}, "
             f"{rcfg.compute_dtype}, remat {rcfg.remat}; the count is steps")
    profile_runs({"train step": step}, label, steps=STEPS)
    time_by_step(step, f"train step ({label})")
    print(f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
