"""The dry run: price every (arch x shape x mesh) cell with no allocation.
Port of ``repro.launch.dryrun``.

Where the reference lowers and compiles XLA executables for 256 and 512
TPU devices on ``ShapeDtypeStruct`` inputs, the port runs its own
functions on fake tensors (``FakeTensorMode``: shapes and dtypes, no
storage) inside a ``fake`` process group of the mesh's size, started in
this process as rank 0 and destroyed after each cell:

* **FLOPs and unfused bytes** (``op_cost``): :func:`repro_torch.runtime.
  flops.cost_of` over the unsharded function at the cell's global shapes
  — ``make_train_step``'s step (gradients, clipping and the optimizer),
  ``model.prefill`` or ``model.decode_step`` — as the reference's
  ``jaxpr_cost`` is global and unsharded;
* **state bytes per device**: the local shards of the DTensors the
  sharded run holds (parameters and optimizer state for train,
  parameters for prefill, parameters and cache for decode), as the
  reference's ``sharded_bytes``;
* **collectives**: what DTensor and the sharded run issue on rank 0 —
  the tensor-parallel train step of
  ``train_step.make_sharded_train_step``, or ``model.prefill`` (its
  cache placed in the rules' layout at the end) / ``model.decode_step``
  on this rank's ``"model"`` shards of the weights, its batch rows and
  its piece of the cache in the rules' layout (a ring split on
  ``cache_seq`` read in place) — counted by ``CommDebugMode`` with each
  collective's result bytes and wire bytes per device by the reference's
  ring formulas: weights gathered over the batch axes, gradients
  reduce-scattered over them, activations all-reduced over ``"model"``,
  or, with ``--seq-parallel``, the sequence all-gathered and
  reduce-scattered over it;
* **FLOPs per device** (``device_cost``): the ops rank 0 runs in that
  sharded run, priced as ``op_cost`` is; a layer the divisibility
  fallback replicated over ``"model"`` counts whole on every card of the
  group (``compute_note`` names them).

Every count is affine in the model's depth, so a model of more than 2
blocks is priced at 1 and 2 blocks of its pattern and extrapolated
(``depth`` in the record), where the reference counts a scanned block
times its trip count.

The record keeps the reference's schema with two changes: ``jaxpr_cost``
is ``op_cost``, and there is no ``xla_cost``.  ``memory`` is None: the
compiled ``memory_analysis`` has no eager counterpart, and the dry run
does not estimate one.  ``host_s`` is the host seconds of the two runs on
the machine that ran them.  A cell whose function reads a value on the
host or grows a data-dependent size fails (fake tensors hold no values)
and writes its traceback to the cell's ``.err`` file.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k [--multi-pod] [--out artifacts/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # every cell
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.archs import ARCHS, skip_reason
from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.runtime import sharding as shd

RULES = shd.ShardingRules(shd.TRAIN_RULES)
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
MEMORY_NOTE = ("no eager counterpart of the compiled memory_analysis; not "
               "estimated")


# optimizer choice per scale: adafactor >= 100B total params
def pick_optimizer(cfg) -> str:
    return "adafactor" if cfg.param_count() > 1e11 else "adamw"


def _microbatches(arch: str, shape_name: str) -> int:
    cfg = ARCHS[arch]
    if shape_name != "train_4k":
        return 1
    # keep per-device token count per microbatch <= ~16k for >20B models
    return 4 if cfg.param_count() > 2e10 else 1


@contextlib.contextmanager
def fake_mesh(dims: tuple, names: tuple, rank: int = 0):
    """A ``DeviceMesh`` of ``dims`` over a ``fake`` process group in this
    process, as ``rank``; the group is destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    world = 1
    for n in dims:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield init_device_mesh("cpu", tuple(dims), mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

_KINDS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all", "broadcast": "broadcast"}
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "broadcast")


def _collective_log_class():
    from torch.distributed.tensor.debug import CommDebugMode

    class CollectiveLog(CommDebugMode):
        """``CommDebugMode`` that also keeps, per functional collective it
        counts, the kind, result bytes and group size."""

        def __init__(self):
            super().__init__()
            self.log: list[tuple[str, int, int]] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or not hasattr(func, "_overloadpacket"):
                return out
            kind = _KINDS.get(func._overloadpacket.__name__.rstrip("_"))
            if kind is not None:
                self.log.append((kind, _nbytes(out), _group_size(args)))
            return out

    return CollectiveLog


def _nbytes(out) -> int:
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(x) for x in out)
    return out.numel() * out.element_size()


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


def collective_stats(log) -> dict:
    """Per kind: count, result bytes and wire bytes per device by the
    reference's ring formulas, with the group sizes; and the totals."""
    per_op = {c: {"count": 0, "result_bytes": 0, "wire_bytes": 0}
              for c in _COLLECTIVES}
    for kind, rb, gsize in log.log:
        n = max(gsize, 2)
        ring = (n - 1) / n
        if kind == "all-reduce":
            wire = 2 * rb * ring
        elif kind == "all-gather":
            wire = rb * ring          # result is the gathered tensor
        elif kind == "reduce-scatter":
            wire = rb * (n - 1)       # operand = result * n
        elif kind == "all-to-all":
            wire = rb * ring
        else:                          # broadcast: the tensor once
            wire = rb
        e = per_op[kind]
        e["count"] += 1
        e["result_bytes"] += int(rb)
        e["wire_bytes"] += int(wire)
        e.setdefault("group_sizes", set()).add(gsize)
    for v in per_op.values():
        if "group_sizes" in v:
            v["group_sizes"] = sorted(v["group_sizes"])
    totals = {k: sum(v[k] for v in per_op.values())
              for k in ("count", "result_bytes", "wire_bytes")}
    return {"per_op": per_op, "totals": totals,
            "comm_debug_counts": {str(k): v for k, v in
                                  log.get_comm_counts().items()}}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def _zeros(tree):
    """Zero tensors on the CPU of ``tree``'s shapes and dtypes (fake
    under ``FakeTensorMode``)."""
    return shd.tree_map_with_path(
        lambda _, x: torch.zeros(x.shape, dtype=x.dtype), tree)


def compute_note(cfg, rules, sizes: dict, seq_parallel: bool = False
                 ) -> str:
    """What each card of a cell computes: its ``"model"`` shard of every
    dim the rules split, and whole the dims the divisibility fallback
    replicated on a ``"model"`` axis of ``sizes``; with ``seq_parallel``,
    attention and the norms on its share of the positions."""
    mesh = type("Sizes", (), {"shape": sizes})()
    dims = {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
            "mlp": cfg.d_ff if any(sp.mlp == "dense"
                                   for sp in cfg.full_pattern) else 0,
            "experts": cfg.num_experts, "vocab": cfg.padded_vocab,
            "ssm_heads": cfg.ssm_heads if cfg.ssm_state else 0}
    whole = [f"{name} {n}" for name, n in dims.items()
             if n and not rules.spec_for((name,), (n,), mesh)]
    n_model = sizes.get("model", 1)
    sp = (f"sequence-parallel over model where the sequence divides: "
          f"attention (every head, the weights read whole) and the norms "
          f"on each card's 1/{n_model} of the positions; "
          if seq_parallel else "")
    return (sp + "tensor-parallel over model: each card computes its 1/"
            f"{n_model} of the heads, MLP, vocab, experts and SSM heads "
            "and its batch rows; "
            + (f"whole on every card of a model group (the fallback "
               f"replicated them): {', '.join(whole)}, so those layers "
               f"take n_model x their share of op_cost/n_devices"
               if whole else "no dim is replicated by the fallback"))


def run_config(cfg, shape, multi_pod: bool, extra: dict,
               arch: str | None = None, shape_name: str | None = None):
    return RunConfig(
        model=cfg, shape=shape, multi_pod=multi_pod,
        optimizer=pick_optimizer(cfg),
        # remat only matters under grad
        remat=extra.get("remat", "full" if shape.kind == "train" else "none"),
        microbatches=extra.get("microbatches", _microbatches(
            arch, shape_name) if arch in ARCHS and shape_name else 1),
        moe_impl=extra.get("moe_impl", "aam"),
        attn_causal_skip=extra.get("attn_causal_skip", False),
        shard_grads=extra.get("shard_grads", False),
        serve_tp=extra.get("serve_tp", False),
        seq_parallel=extra.get("seq_parallel", False),
    )


def cell_cost(cfg, rcfg, shape, param_dtype):
    """``cost_of`` the unsharded function of the cell at its global
    shapes, on the tensors made here (fake under ``FakeTensorMode``)."""
    from repro_torch.models import model as M
    from repro_torch.runtime.flops import cost_of
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step
    model = M.skeleton(cfg, param_dtype)
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        model.get_submodule(mod_name)._parameters[leaf] = torch.nn.Parameter(
            torch.zeros(p.shape, dtype=p.dtype))
    batch = _zeros(M.input_specs(cfg, shape))
    if shape.kind == "train":
        opt = make_optimizer(rcfg)
        params = dict(model.named_parameters())
        step = make_train_step(cfg, rcfg, model, opt)
        return cost_of(step, params, opt.init(params), 0, batch)
    if shape.kind == "prefill":
        return cost_of(M.prefill, cfg, rcfg, model, batch)
    cache = _zeros(M.cache_specs(cfg, rcfg, shape))
    return cost_of(M.decode_step, cfg, rcfg, model, cache, batch["token"],
                   shape.seq_len - 1)


def sharded_run(cfg, rcfg, shape, mesh, rules, param_dtype):
    """(state bytes per device, collective stats) of the cell's sharded
    run on ``mesh``, rank 0's view."""
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (make_sharded_train_step,
                                              sharded_model)
    params = shd.shard_tree(_zeros(M.param_specs(cfg, param_dtype)), rules,
                            mesh)
    batch = _zeros(M.input_specs(cfg, shape))
    log = _collective_log_class()()
    state = shd.local_bytes(params)
    if shape.kind == "train":
        opt = make_optimizer(rcfg)
        whole = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in M.param_specs(cfg, param_dtype).items()}
        opt_state = shd.shard_tree(opt.init(whole), RULES, mesh)
        step = make_sharded_train_step(cfg, rcfg, opt, mesh, rules)
        with log:
            step(params, opt_state, 0, batch)
        state += shd.local_bytes(opt_state)
        return state, collective_stats(log)
    model, slots = sharded_model(cfg, rcfg)
    shd.bind(slots, params)
    local = shd.batch_shard(batch, mesh)
    if shape.kind == "prefill":
        with log:
            M.prefill(cfg, rcfg, model, local, max_len=shape.seq_len)
        return state, collective_stats(log)
    cache = M.init_cache(cfg, rcfg, local["token"].shape[0], shape.seq_len,
                         device="cpu", model=model)
    with log:
        M.decode_step(cfg, rcfg, model, cache, local["token"],
                      shape.seq_len - 1)
    return state + shd.local_bytes(cache), collective_stats(log)


def _at_depth(cfg, blocks: int):
    """``cfg`` cut to ``blocks`` repeats of its pattern (whisper's encoder
    in proportion)."""
    cut = {"num_layers": blocks * len(cfg.full_pattern)}
    if cfg.encoder_layers:
        cut["encoder_layers"] = cfg.encoder_layers // cfg.num_blocks * blocks
    return dataclasses.replace(cfg, **cut)


def _depths(cfg, extrapolate: bool) -> tuple:
    """The depths (in blocks) a cell is priced at: 1 and 2 blocks, whose
    difference is one block's share, when the model is deeper and every
    count is affine in its depth; else its own."""
    b = cfg.num_blocks
    whole = not cfg.encoder_layers or cfg.encoder_layers % b == 0
    return (1, 2) if extrapolate and b > 2 and whole else (b,)


def _affine(x1, x2, blocks: int):
    """``x1 + (x2 - x1) · (blocks - 1)`` through dicts; lists (group
    sizes) from ``x2``."""
    if isinstance(x2, dict):
        return {k: _affine(x1.get(k, 0), x2[k], blocks) for k in x2}
    if isinstance(x2, (int, float)):
        return x1 + (x2 - x1) * (blocks - 1)
    return x2


def _price(cfg, rcfg, shape, dims, names, rules, param_dtype) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.analysis.optrace import OpRecorder
    from repro_torch.runtime.flops import records_cost
    t0 = time.perf_counter()
    with FakeTensorMode():
        cost = cell_cost(cfg, rcfg, shape, param_dtype)
    t_cost = time.perf_counter() - t0
    with fake_mesh(dims, names) as dm, FakeTensorMode():
        with OpRecorder() as rec:
            state_bytes, coll = sharded_run(cfg, rcfg, shape, dm, rules,
                                            param_dtype)
    device = records_cost(r for r in rec.records
                          if not r.name.startswith("_c10d_functional::"))
    return {"op_cost": {"flops": cost.flops, "dot_flops": cost.dot_flops,
                        "bytes_unfused": cost.bytes,
                        "by_prim": dict(cost.by_prim)},
            "device_cost": {"flops": device.flops,
                            "dot_flops": device.dot_flops},
            "state_bytes_per_device": state_bytes, "collectives": coll,
            "host_s": {"op_cost": t_cost,
                       "sharded_run": time.perf_counter() - t0 - t_cost}}


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               extra: dict | None = None, *, cfg=None, shape=None,
               mesh=None, extrapolate: bool = True) -> dict:
    """Price one cell with no allocation.  Returns the record.  ``cfg``,
    ``shape`` and ``mesh`` (``(dims, names)``) replace the arch's config,
    the shape and the production mesh (tests price smoke widths).

    Every count of a cell — FLOPs, bytes, state bytes, each collective's
    count and bytes — is affine in the model's depth: each block of the
    pattern adds the same work, gathers and reductions.  So a model of
    more than 2 blocks is priced at 1 and 2 blocks and its counts
    extrapolated (``extrapolate=False`` runs it whole); ``depth`` in the
    record says which."""
    cfg = cfg or ARCHS[arch]
    shape = shape or SHAPES[shape_name]
    dims, names = mesh or MESHES[multi_pod]
    extra = extra or {}
    rcfg = run_config(cfg, shape, multi_pod, extra, arch, shape_name)
    serve_tp = rcfg.serve_tp and shape.kind != "train"
    rules = (shd.ShardingRules(shd.SERVE_TP_RULES) if serve_tp else RULES)
    param_dtype = torch.bfloat16 if serve_tp else torch.float32

    depths = _depths(cfg, extrapolate)
    runs = []
    for blocks in depths:
        cut = _at_depth(cfg, blocks)
        runs.append(_price(cut, dataclasses.replace(rcfg, model=cut), shape,
                           dims, names, rules, param_dtype))
    priced = runs[0] if len(runs) == 1 else _affine(*runs, cfg.num_blocks)
    priced["host_s"] = {k: sum(r["host_s"][k] for r in runs)
                        for k in runs[0]["host_s"]}
    cost = priced["op_cost"]
    by_prim = cost.pop("by_prim")
    cost["top_prims"] = dict(sorted(by_prim.items(),
                                    key=lambda kv: -kv[1])[:8])
    coll = priced["collectives"]

    n_devices = 1
    for n in dims:
        n_devices *= n
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_act = cfg.active_param_count()
    model_flops = (6 if shape.kind == "train" else 2) * n_act * tokens
    record = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, dims)),
        "mesh_shape": dict(zip(names, dims)),
        "n_devices": n_devices,
        "kind": shape.kind,
        "optimizer": rcfg.optimizer,
        "microbatches": rcfg.microbatches,
        "moe_impl": rcfg.moe_impl,
        "depth": {"blocks": cfg.num_blocks, "priced_blocks": list(depths)},
        "host_s": priced["host_s"],
        "memory": None, "memory_note": MEMORY_NOTE,
        "compute_note": compute_note(cfg, rules, dict(zip(names, dims)),
                                     rcfg.seq_parallel and
                                     shape.kind != "decode"),
        "state_bytes_per_device": int(priced["state_bytes_per_device"]),
        "op_cost": cost,
        "device_cost": priced["device_cost"],
        "model_flops": float(model_flops),
        "collectives": coll,
        "params_total": cfg.param_count(),
        "params_active": n_act,
    }
    print(f"state_bytes/device: {record['state_bytes_per_device'] / 2**30:.2f}"
          f" GiB")
    print(f"op flops={cost['flops']:.3e} dot={cost['dot_flops']:.3e} "
          f"model_flops={model_flops:.3e}; rank 0 computes "
          f"{priced['device_cost']['flops']:.3e}")
    print(f"collectives: {coll['totals']}")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--moe-impl", default=None, choices=["aam", "dense"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--causal-skip", action="store_true")
    ap.add_argument("--shard-grads", action="store_true")
    ap.add_argument("--serve-tp", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = [(a, s, mp) for a in ARCHS for s in SHAPES
                 for mp in (False, True)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, args.multi_pod)]

    extra = {}
    if args.moe_impl:
        extra["moe_impl"] = args.moe_impl
    if args.microbatches:
        extra["microbatches"] = args.microbatches
    for flag, key in (("causal_skip", "attn_causal_skip"),
                      ("shard_grads", "shard_grads"),
                      ("serve_tp", "serve_tp"),
                      ("seq_parallel", "seq_parallel")):
        if getattr(args, flag):
            extra[key] = True

    failures = 0
    for arch, shape_name, mp in cells:
        mesh_tag = "2x16x16" if mp else "16x16"
        stem = f"{arch}__{shape_name}__{mesh_tag}{args.tag}"
        path = outdir / f"{stem}.json"
        reason = skip_reason(arch, shape_name)
        if reason:
            path.write_text(json.dumps(
                {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                 "skipped": reason}, indent=1))
            print(f"[skip] {stem}: {reason}")
            continue
        print(f"[cell] {stem} ...", flush=True)
        try:
            rec = build_cell(arch, shape_name, mp, extra)
            rec["tag"] = args.tag
            path.write_text(json.dumps(rec, indent=1))
            print(f"[ok]   {stem} host_s={sum(rec['host_s'].values()):.1f} "
                  f"op_flops={rec['op_cost']['flops']:.3e}", flush=True)
        except Exception:
            failures += 1
            err = traceback.format_exc()
            path.with_suffix(".err").write_text(err)
            print(f"[FAIL] {stem}\n{err}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
