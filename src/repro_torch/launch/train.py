"""Training launcher: port of ``repro.launch.train``.

The supervised loop of the reference on one device: weights drawn from
``--seed`` → train step → :class:`TrainSupervisor` with async checkpoints,
the straggler watchdog, restore-on-failure and exact resume from
``--ckpt-dir`` (the port's :class:`Checkpointer`, the reference's
on-disk format).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

The flags are the reference launcher's plus ``--device`` (default
``cuda``; without a card it raises rather than train on the CPU).
``--production-mesh`` raises: the port runs on one card.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
from repro_torch.data.pipeline import TokenStream
from repro_torch.runtime.fault_tolerance import (StragglerWatchdog,
                                                 TrainSupervisor,
                                                 restore_template)
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import init_train_state, make_train_step


def build(arch: str, *, smoke: bool, batch: int, seq: int, lr: float,
          microbatches: int, moe_impl: str, production_mesh: bool):
    if production_mesh:
        raise ValueError("--production-mesh: the port runs on one card; "
                         "the reference's 16 x 16 TPU mesh has no "
                         "counterpart here")
    cfg = ARCHS[arch]
    if smoke:
        cfg = smoke_model(cfg)
    shape = ShapeConfig("cli", seq, batch, "train")
    rcfg = RunConfig(model=cfg, shape=shape, learning_rate=lr,
                     microbatches=microbatches, moe_impl=moe_impl,
                     remat="full" if not smoke else "none")
    return cfg, rcfg


def main(argv=None) -> dict:
    """Returns ``{"start", "final", "log"}``: the step it resumed from (0
    for a fresh run), the last step and the logged metrics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moe-impl", default="aam", choices=["aam", "dense"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, rcfg = build(
        args.arch, smoke=args.smoke, batch=args.batch, seq=args.seq,
        lr=args.lr, microbatches=args.microbatches, moe_impl=args.moe_impl,
        production_mesh=args.production_mesh)
    print(f"[launch] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"device {device}")

    opt = make_optimizer(rcfg)
    model, params, opt_state = init_train_state(cfg, rcfg, opt,
                                                seed=args.seed, device=device)
    step_fn = make_train_step(cfg, rcfg, model, opt)
    stream = TokenStream(cfg, rcfg.shape, seed=args.seed)
    ckpt = Checkpointer(args.ckpt_dir)
    sup = TrainSupervisor(ckpt, save_every=args.save_every,
                          watchdog=StragglerWatchdog())

    start = 0
    if ckpt.latest_step() is not None:
        template, _ = restore_template((params, opt_state))
        (params, opt_state), start = ckpt.restore(template, device=device)
        print(f"[launch] resumed from step {start}")

    def run_step(state, step, batch):
        params, opt_state = state
        params, opt_state, metrics = step_fn(params, opt_state, step, batch)
        return (params, opt_state), metrics

    t0 = time.time()
    _, final, log = sup.run(
        (params, opt_state), run_step,
        lambda step: stream.tensors(step, device=device),
        start_step=start, num_steps=args.steps)
    dt = time.time() - t0
    tokens = max(args.steps - start, 0) * args.batch * args.seq
    print(f"[launch] done: {final} steps, {tokens/dt:.0f} tok/s, "
          f"final metrics: {log[-1][1] if log else {}}")
    return {"start": start, "final": final, "log": log}


if __name__ == "__main__":
    main()
