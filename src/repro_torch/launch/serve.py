"""Serving launcher: batched prefill + greedy (or temperature) decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --batch 4 --prompt-len 32 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The flags and the default arch are the reference launcher's
(``repro.launch.serve``) plus ``--device``.  Weights
are drawn at random on the device from ``--seed``; the prompt, and
whisper's frame or pixtral's patch-embedding stubs (bf16), are drawn with
numpy from the same seed.  The SSD chunk runs through the hand-written
kernel (``use_pallas``) and the MoE's bucket count through its own; on
the CPU their plain versions.

Under ``torchrun`` with more than one rank it serves tensor-parallel on
the reference's serving mesh, ``make_host_mesh(1, world)``, in the
``SERVE_TP_RULES`` layout: each rank keeps its ``"model"`` shard of the
weights and computes on it (over NCCL with a card a rank; over gloo on
the CPU or where ranks share a card, which NCCL refuses); rank 0
prints.

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch qwen2-1.5b
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
from repro_torch.models import model as M
from repro_torch.runtime import sharding as shd
from repro_torch.serve.serve_step import generate


def serving_mesh(device):
    """The reference's serving mesh ``make_host_mesh(1, world)`` when the
    job has more than one rank (``WORLD_SIZE`` from ``torchrun``), else
    None.  Starts the process group unless one is running: NCCL when each
    rank has a card of its own, else gloo."""
    import os
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return None
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    if not dist.is_initialized():
        own_card = dev.type == "cuda" and world <= torch.cuda.device_count()
        dist.init_process_group("nccl" if own_card else "gloo")
    return make_host_mesh(1, world, device=dev.type)


def tensor_parallel(cfg, rcfg, model, mesh):
    """``model``'s weights kept as this rank's shards in the
    ``SERVE_TP_RULES`` layout, bound to a skeleton whose layers compute on
    them."""
    from repro_torch.train.train_step import sharded_model
    params = shd.shard_tree(dict(model.named_parameters()),
                            shd.ShardingRules(shd.SERVE_TP_RULES), mesh)
    tp, slots = sharded_model(cfg, rcfg)
    shd.bind(slots, params)
    return tp


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
    import torch.distributed as dist
    started = not dist.is_initialized()
    mesh = serving_mesh(args.device)
    try:
        return _serve(args, mesh)
    finally:
        if mesh is not None and started:
            dist.destroy_process_group()


def _serve(args, mesh):
    """Prefill and decode; returns the generated tokens [B, new] on the
    host (every rank)."""
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_model(cfg)
    shape = ShapeConfig("serve", args.prompt_len + args.new_tokens,
                        args.batch, "decode")
    rcfg = RunConfig(model=cfg, shape=shape, remat="none", use_pallas=True)

    rng = np.random.default_rng(args.seed)
    model = M.init(cfg, args.seed, device=args.device)
    if mesh is not None:
        model = tensor_parallel(cfg, rcfg, model, mesh)
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
    if mesh is not None and mesh.get_rank() != 0:
        return toks
    where = "" if mesh is None else f" on {mesh.size()} ranks (1 x " \
        f"{mesh.size()} mesh, SERVE_TP_RULES)"
    print(f"[serve] {args.arch}: generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s){where}")
    print("[serve] sample:", toks[0][:16].numpy())
    return toks


if __name__ == "__main__":
    main()
