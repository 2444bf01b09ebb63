"""Serving launcher: batched prefill + greedy (or temperature) decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --batch 4 --prompt-len 32 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The flags and the default arch are the reference launcher's
(``repro.launch.serve``) plus ``--device``.  Weights are drawn at random on
the device from ``--seed``; the prompt, and whisper's frame or pixtral's
patch-embedding stubs (bf16), are drawn with numpy from the same seed.
The SSD chunk runs through the hand-written kernel (``use_pallas``) and
the MoE's bucket count through its own; on the CPU their plain versions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
from repro_torch.models import model as M
from repro_torch.serve.serve_step import generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_model(cfg)
    shape = ShapeConfig("serve", args.prompt_len + args.new_tokens,
                        args.batch, "decode")
    rcfg = RunConfig(model=cfg, shape=shape, remat="none", use_pallas=True)

    rng = np.random.default_rng(args.seed)
    model = M.init(cfg, args.seed, device=args.device)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32)}
    if cfg.encoder_layers:
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (args.batch, cfg.encoder_seq, cfg.d_model)), dtype=torch.bfloat16)
    if cfg.frontend == "patch":
        batch["patch_embeds"] = torch.as_tensor(rng.standard_normal(
            (args.batch, cfg.frontend_seq, cfg.d_model)),
            dtype=torch.bfloat16)
    t0 = time.time()
    toks = generate(cfg, rcfg, model, batch, max_new_tokens=args.new_tokens,
                    temperature=args.temperature, seed=args.seed,
                    device=args.device).cpu()
    dt = time.time() - t0
    print(f"[serve] {args.arch}: generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    print("[serve] sample:", toks[0][:16].numpy())


if __name__ == "__main__":
    main()
