"""Where LM serving's device time goes: ``torch.profiler`` over a prefill
and decode steps of one architecture at its published width on one card.

    PYTHONPATH=src python3 -m repro_torch.obs.serve_profile
    PYTHONPATH=src python3 -m repro_torch.obs.serve_profile \\
        --arch phi3.5-moe-42b-a6.6b --layers 8 --batch 4

Draws the model's weights on the card from seed 0 (as ``chip_smoke.py``
phases 7 and 11 do; ``--layers`` cuts the depth, never the width), then
profiles one prefill of ``--batch`` x 2048 tokens (default 8 x 2048,
mamba2-780m) and a run of 8 greedy decode steps from its cache,
bf16 compute, on the kernels' path, each after one warm-up run.  Prints
the card, each run's wall time, the device's busy share (the sum of
kernel times over the wall time), the kernels that took most of the
device time and the device time by kernel class (the SSD kernel, GEMMs,
copies and casts, the rest: elementwise passes, reductions, the einsums'
own kernels).  Then, from CUDA events around the model's own functions
in one more run, the device time by step: MoE routing, the dispatch's
plan (the bucket-count kernel with its sort) and scatter, the expert
FFNs (their GEMMs and the per-call casts of the expert weights), the
combine's gather, the attention core (logits, softmax, P·V; the
projections are outside it), the SSD mixer, and the rest.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time

from repro_torch.obs.round_profile import profile_runs

PROMPT_LEN = 2048
DECODE_STEPS = 8
STEPS = (("SSD kernel", ("ssd_chunk_kernel",)),
         ("GEMMs", ("gemm", "gemv", "nvjet", "xmma", "cutlass")),
         ("copies/casts", ("copy", "Memcpy", "Memset")))


def _ranges():
    """(module, function name, step) of the functions timed by step."""
    from repro_torch.models import attention, lm
    from repro_torch.moe import moe_layer
    return ((moe_layer, "_route", "MoE routing"),
            (moe_layer, "plan_buckets_sorted", "dispatch: plan"),
            (moe_layer, "scatter_to_buckets", "dispatch: scatter"),
            (moe_layer, "_expert_ffn", "expert FFNs"),
            (moe_layer, "_combine", "combine: gather"),
            (attention, "attention_core", "attention core"),
            (lm, "ssm_apply", "SSD mixer"),
            (lm, "ssm_decode", "SSD mixer"))


def time_by_step(run, label):
    """Run ``run`` once with CUDA events around the functions of
    :func:`_ranges` (none of which calls another) and print each step's
    device ms beside the run's, timed the same way."""
    import torch
    spans, undo = [], []

    def wrap(module, name, step):
        fn = getattr(module, name)

        def timed_fn(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            spans.append((step, start, end))
            return out
        setattr(module, name, timed_fn)
        undo.append(lambda: setattr(module, name, fn))
    for module, name, step in _ranges():
        wrap(module, name, step)
    try:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
    finally:
        for u in undo:
            u()
    total = start.elapsed_time(end)
    by_step = {}
    for step, s, e in spans:
        by_step[step] = by_step.get(step, 0.0) + s.elapsed_time(e)
    by_step["the rest"] = total - sum(by_step.values())
    print(f"{label}: {total:.3f} device ms between events; by step: "
          + ", ".join(f"{name} {ms:.3f} ms ({ms / total:.3f})" for name, ms
                      in sorted(by_step.items(), key=lambda kv: -kv[1])))


def main(argv=None) -> int:
    import torch
    from repro_torch.configs.archs import ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="mamba2-780m")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device", file=sys.stderr)
        return 1
    import dataclasses
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import model as M
    from repro_torch.serve.serve_step import pad_cache

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    cfg = ARCHS[args.arch]
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    b, s = args.batch, PROMPT_LEN
    rcfg = RunConfig(model=cfg, shape=ShapeConfig(
        "serve", s + DECODE_STEPS, b, "decode"), use_pallas=True)
    t0 = time.perf_counter()
    model = M.init(cfg, 0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     device="cuda", generator=gen)}
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(b, cfg.encoder_seq, cfg.d_model,
                                      device="cuda", generator=gen)
    if cfg.frontend == "patch":
        batch["patch_embeds"] = torch.randn(b, cfg.frontend_seq,
                                            cfg.d_model, device="cuda",
                                            generator=gen)
    prompt = s + (cfg.frontend_seq if cfg.frontend == "patch" else 0)
    logits, cache = M.prefill(cfg, rcfg, model, batch)
    cache = pad_cache(cfg, cache, prompt + DECODE_STEPS)
    first = logits.argmax(-1).to(torch.int32)
    del logits
    torch.cuda.synchronize()
    print(f"{args.arch}: {cfg.num_layers} layers, weights drawn and the "
          f"first prefill in {time.perf_counter() - t0:.1f} s")

    def prefill():
        M.prefill(cfg, rcfg, model, batch)
        return 1

    def decode():
        c, tok = cache, first
        for i in range(DECODE_STEPS):
            lg, c = M.decode_step(cfg, rcfg, model, c, tok, prompt + i)
            tok = lg.argmax(-1).to(torch.int32)
        return DECODE_STEPS

    label = (f"{args.arch}, {cfg.num_layers} layers, {b} x {s} tokens, "
             f"{rcfg.compute_dtype}, kernel path")
    profile_runs({"prefill": prefill}, f"{label}; the count is prefills",
                 steps=STEPS)
    time_by_step(prefill, f"prefill ({label})")
    profile_runs({"decode": decode},
                 f"{label}; the count is decode steps", steps=STEPS)
    time_by_step(decode, f"{DECODE_STEPS} decode steps ({label})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
