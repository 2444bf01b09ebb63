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
``cuda``; without a card it raises rather than train on the CPU) and
``--mesh DATA,MODEL``.  With ``--production-mesh`` (256 ranks; 512 with
``--multi-pod``) or ``--mesh`` the launcher runs on a ``DeviceMesh`` under
``torchrun``: it starts the process group from the environment (NCCL on
the card, gloo on the CPU), places its parameters and optimizer state
with ``shard_tree`` in the training rules' layout, as the reference's
``device_put`` does, and trains with ``make_sharded_train_step``.
Checkpoints hold the whole state: every rank gathers it, rank 0 writes
it, and a restore reads it whole and keeps each rank's shards.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \
      --device cpu --mesh 2,2 --steps 20
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
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.fault_tolerance import (StragglerWatchdog,
                                                 TrainSupervisor,
                                                 restore_template)
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import (RULES, init_train_state,
                                          make_sharded_train_step,
                                          make_train_step)


class ShardedCheckpointer:
    """A :class:`Checkpointer` for a state of DTensors: every rank
    gathers the state whole (a collective, so every rank calls
    :meth:`save` at the same steps), rank 0 writes it, and
    :meth:`restore` reads it whole on every rank and keeps each rank's
    shards in the rules' layout."""

    def __init__(self, ckpt: Checkpointer, mesh, rules=RULES):
        import torch.distributed as dist
        self.ckpt, self.mesh, self.rules = ckpt, mesh, rules
        self.writer = dist.get_rank() == 0

    def save(self, step: int, tree, *, blocking: bool = True):
        whole = shd.tree_map_with_path(lambda _, x: x.full_tensor(), tree)
        if self.writer:
            self.ckpt.save(step, whole, blocking=blocking)

    def wait(self):
        self.ckpt.wait()

    def latest_step(self):
        return self.ckpt.latest_step()

    def restore(self, template, step=None, *, device="cuda"):
        whole, step = self.ckpt.restore(template, step, device=device)
        return shd.shard_tree(whole, self.rules, self.mesh), step


def _start_group(device, need: int):
    """The default process group from ``torchrun``'s environment, if none
    is running, after checking that it has ``need`` ranks; this rank's
    device."""
    import torch
    import torch.distributed as dist
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if world != need:
        raise ValueError(f"this mesh needs world size {need}, the job has "
                         f"{world}: run under torchrun --nproc-per-node "
                         f"{need} (or across hosts)")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


def build(arch: str, *, smoke: bool, batch: int, seq: int, lr: float,
          microbatches: int, moe_impl: str, production_mesh: bool,
          multi_pod: bool = False, mesh=None, device="cuda"):
    """(cfg, rcfg, mesh): the mesh is None on one device, else the
    production mesh or ``mesh`` (``(data, model)``) over the running
    process group."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    cfg = ARCHS[arch]
    if smoke:
        cfg = smoke_model(cfg)
    shape = ShapeConfig("cli", seq, batch, "train")
    rcfg = RunConfig(model=cfg, shape=shape, learning_rate=lr,
                     microbatches=microbatches, moe_impl=moe_impl,
                     remat="full" if not smoke else "none",
                     multi_pod=multi_pod)
    if production_mesh:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    elif mesh is not None:
        mesh = make_host_mesh(*mesh, device=device)
    return cfg, rcfg, mesh


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
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL: a host mesh over the torchrun group")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.production_mesh:
        device = _start_group(device, 512 if args.multi_pod else 256)
    elif args.mesh is not None:
        data, model_ = (int(x) for x in args.mesh.split(","))
        device = _start_group(device, data * model_)
    cfg, rcfg, mesh = build(
        args.arch, smoke=args.smoke, batch=args.batch, seq=args.seq,
        lr=args.lr, microbatches=args.microbatches, moe_impl=args.moe_impl,
        production_mesh=args.production_mesh, multi_pod=args.multi_pod,
        mesh=(tuple(int(x) for x in args.mesh.split(","))
              if args.mesh else None), device=device)
    print(f"[launch] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"device {device}"
          + (f", mesh {shd.mesh_shape(mesh)}" if mesh is not None else ""))

    opt = make_optimizer(rcfg)
    model, params, opt_state = init_train_state(cfg, rcfg, opt,
                                                seed=args.seed, device=device)
    ckpt = Checkpointer(args.ckpt_dir)
    if mesh is None:
        step_fn = make_train_step(cfg, rcfg, model, opt)
    else:
        params = shd.shard_tree(params, RULES, mesh)
        opt_state = shd.shard_tree(opt_state, RULES, mesh)
        del model
        step_fn = make_sharded_train_step(cfg, rcfg, opt, mesh, RULES)
        ckpt = ShardedCheckpointer(ckpt, mesh)
    stream = TokenStream(cfg, rcfg.shape, seed=args.seed)
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
