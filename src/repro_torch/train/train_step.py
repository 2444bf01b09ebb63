"""Train step: loss → grads (microbatched) → clip → optimizer update.

Port of ``repro.train.train_step``.  The model is an ``nn.Module`` built
by :func:`repro_torch.models.model.init`; the parameters the step takes
and returns are ``dict(model.named_parameters())``, the model's own
tensors, which the optimizer updates in place.  Gradients come from
``torch.autograd.grad`` as a dict over the same names.  Microbatching
(sequential gradient accumulation in f32) bounds activation memory
independently of the global batch.  Nothing in a step reads a value on
the host: the loss, the norm and the metrics stay on the device.

:func:`make_sharded_train_step` is the same step on a ``DeviceMesh``
(:func:`repro_torch.launch.mesh.make_host_mesh` or
``make_production_mesh``):

* *storage follows the rules* (:mod:`repro_torch.runtime.sharding`):
  parameters and optimizer state are DTensors in the rules' layout (FSDP
  over ``"data"``; heads, mlp, vocab, experts and SSM heads over
  ``"model"``), and the global batch splits over ``("pod", "data")``;
* *compute is tensor-parallel over ``"model"``*: where a layer reads a
  weight, it is gathered over the batch dims only (again in remat's
  recomputation) and the rank keeps its ``"model"`` shard; the layers
  compute on the local heads, MLP columns, vocab rows, experts and SSM
  heads, with an all-reduce over ``"model"`` where a row-parallel product,
  the vocab-parallel lookup and cross entropy, the gated SSM norm or a
  gradient entering the sharded region needs one.  A leaf the
  divisibility fallback replicated is computed whole on every rank of
  its group (e.g. qwen2's 12 heads on a 16-wide axis).  Each weight's
  gradient is its shard's, summed over the batch axes by the gather's
  backward (a reduce-scatter into its layout); the optimizer updates the
  shards (AdamW touches only local elements; Adafactor's factored means
  and update clip reduce over the mesh).

An MoE layer in ``mode="train"`` sizes its capacity from the tokens it
sees, so under a data-parallel split each shard drops its own overflow:
the sharded step's gradients are the mean, over the data shards, of the
unsharded step's on each shard, where the reference's SPMD step routes the
global batch in every MoE layer.  Within a ``"model"`` group every rank
routes the same tokens, so the experts' split changes nothing there.

With ``rcfg.seq_parallel``, where the rules split ``act_seq``, the
step is sequence-parallel over ``"model"`` as well
(:func:`repro_torch.models.lm.apply_layer`), in remat's recomputation and
in each microbatch alike: a weight read by compute on a rank's positions
has a partial gradient, summed over the group by its crossing.

:func:`constrain_like_params` pins a gradient tree to the parameters'
layout when its leaves are DTensors (``rcfg.shard_grads``); on plain
tensors it is the identity.  The explicit data-parallel step with int8
gradient compression is :mod:`repro_torch.train.grad_compression`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model as M
from repro_torch.runtime import sharding as shd
from repro_torch.train.optimizer import Optimizer, make_optimizer

RULES = shd.ShardingRules(shd.TRAIN_RULES)


def constrain_like_params(tree, rules: shd.ShardingRules = RULES):
    """A gradient or accumulator tree placed like its parameters: each
    DTensor leaf redistributed to the rules' layout for its name, a plain
    leaf unchanged."""
    return shd.tree_map_with_path(
        lambda path, g: shd.logical_constraint(
            rules, g, shd.resolve_axes(path, g.dim()))
        if shd.is_dtensor(g) else g, tree)


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


def clip_by_global_norm(tree: dict, max_norm: float):
    """Scales every leaf (in place) so the global norm is at most
    ``max_norm``.  Returns (tree, the norm before clipping)."""
    g = global_norm(tree)
    scale = torch.clamp_max(max_norm / g.clamp_min(1e-12), 1.0)
    for x in tree.values():
        x.mul_(scale)
    return tree, g


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    def check(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        return b // n
    size = {k: check(x) for k, x in batch.items()}
    return [{k: x[i * size[k]:(i + 1) * size[k]] for k, x in batch.items()}
            for i in range(n)]


def _value_and_grad(cfg, rcfg, model, params: dict, batch):
    loss, metrics = M.loss_fn(cfg, rcfg, model, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(params, grads)))


def grads_fn(cfg: ModelConfig, rcfg: RunConfig, model, batch):
    """Microbatched grads + metrics (mean over microbatches).  Returns
    (grads, loss, metrics); with microbatches the grads and metrics are
    f32."""
    params = dict(model.named_parameters())
    n = rcfg.microbatches
    maybe_shard = constrain_like_params if rcfg.shard_grads else (
        lambda t: t)
    if n <= 1:
        loss, metrics, grads = _value_and_grad(cfg, rcfg, model, params,
                                               batch)
        return maybe_shard(grads), loss, metrics

    g_acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    l_acc, m_acc = None, None
    for mb in _split_microbatches(batch, n):
        loss, metrics, g = _value_and_grad(cfg, rcfg, model, params, mb)
        for k, a in g.items():
            g_acc[k].add_(a.float())
        l_acc = loss / n if l_acc is None else l_acc + loss / n
        m = {k: v.float() / n for k, v in metrics.items()}
        m_acc = m if m_acc is None else {k: m_acc[k] + m[k] for k in m}
    for a in g_acc.values():
        a.div_(n)
    return maybe_shard(g_acc), l_acc, m_acc


def bind_params(model, params: dict) -> dict:
    """The model's own parameters, holding the values of ``params`` (a
    restored checkpoint's tensors are copied in; the model's own pass
    through)."""
    own = dict(model.named_parameters())
    if own.keys() != params.keys():
        raise ValueError(f"parameters {sorted(set(own) ^ set(params))} "
                         f"differ from the model's")
    with torch.no_grad():
        for k, p in own.items():
            if params[k] is not p:
                p.copy_(params[k])
    return own


def _on(batch: dict, device) -> dict:
    return {k: (torch.from_numpy(x) if isinstance(x, np.ndarray)
                else x).to(device) for k, x in batch.items()}


def make_train_step(cfg: ModelConfig, rcfg: RunConfig, model,
                    opt: Optimizer | None = None):
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    metrics)`` on ``model``'s device; ``batch`` may hold numpy arrays or
    tensors, ``step`` is an int or a 0-d tensor."""
    opt = opt or make_optimizer(rcfg)
    device = next(model.parameters()).device

    def train_step(params, opt_state, step, batch):
        params = bind_params(model, params)
        grads, loss, metrics = grads_fn(cfg, rcfg, model, _on(batch, device))
        grads, gnorm = clip_by_global_norm(grads, rcfg.grad_clip)
        params, opt_state = opt.update(grads, opt_state, params, step)
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm, step=step + 1)
        return params, opt_state, metrics

    return train_step


def sharded_model(cfg: ModelConfig, rcfg: RunConfig):
    """(model, slots): the model's modules on ``meta`` whose parameters
    read this rank's ``"model"`` shards of bound DTensors, gathered over
    the other mesh dims on every access
    (:func:`repro_torch.runtime.sharding.gather_on_use`); the layers then
    compute tensor-parallel."""
    model = M.skeleton(cfg, getattr(torch, rcfg.param_dtype))
    return model, shd.gather_on_use(model)


def sharded_global_norm(tree: dict, mesh) -> torch.Tensor:
    """The global norm of a tree of DTensors in Shard/Replicate layouts:
    each rank's sum of squares, each element counted once (divided by the
    ranks that replicate it), summed over the mesh."""
    local = None
    for x in tree.values():
        reps = 1
        for d, p in enumerate(x.placements):
            if p.is_replicate():
                reps *= mesh.size(d)
        s = x.to_local().float().square().sum() / reps
        local = s if local is None else local + s
    return torch.sqrt(shd.all_reduce_over(local, mesh,
                                          mesh.mesh_dim_names))


def make_sharded_grads(cfg: ModelConfig, rcfg: RunConfig, mesh,
                       rules: shd.ShardingRules = RULES):
    """``grads(params, batch) -> (grads, stats, names)`` on ``mesh``: the
    gradients of this rank's rows of the global ``batch`` as DTensors in
    the parameters' layout (summed over the batch shards, so they are the
    mean loss's), and ``stats`` [1 + len(names)], the loss and the metrics
    ``names`` on this rank's rows (means over microbatches)."""
    model, slots = sharded_model(cfg, rcfg)
    _, shards = shd.batch_coordinate(mesh)
    device = torch.device(mesh.device_type)
    n = max(rcfg.microbatches, 1)

    def grads_of(params, batch):
        # autograd leaves aliasing the DTensors' shards
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        shd.bind(slots, leaves)
        local = shd.batch_shard(_on(batch, device), mesh)
        grads, stats = None, None
        try:
            for mb in (_split_microbatches(local, n) if n > 1 else [local]):
                loss, metrics = M.loss_fn(cfg, rcfg, model, mb)
                g = torch.autograd.grad(loss / (shards * n),
                                        list(leaves.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
                g = dict(zip(leaves, (a.float() if n > 1 else a for a in g)))
                grads = g if grads is None else {k: grads[k] + g[k]
                                                 for k in grads}
                s = torch.stack([loss.detach().float()] + [
                    v.detach().float() for v in metrics.values()]) / n
                stats = s if stats is None else stats + s
        finally:
            shd.bind(slots, params)
        if rcfg.shard_grads:
            grads = constrain_like_params(grads, rules)
        return grads, stats, list(metrics)

    return grads_of


def make_sharded_train_step(cfg: ModelConfig, rcfg: RunConfig,
                            opt: Optimizer | None, mesh,
                            rules: shd.ShardingRules = RULES):
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    metrics)`` on ``mesh``: ``params`` and ``opt_state`` are DTensors
    (:func:`repro_torch.runtime.sharding.shard_tree` with ``rules``),
    updated in place and returned; ``batch`` is the global batch, the same
    on every rank, of which each rank computes its rows.  The loss and
    metrics are means over the batch shards; ``grad_norm`` is the global
    norm.  Every rank of the mesh calls it (the collectives are the
    mesh's); the ranks of a ``"model"`` group compute tensor-parallel on
    the same rows."""
    from torch.distributed.tensor.experimental import implicit_replication
    opt = opt or make_optimizer(rcfg)
    grads_of = make_sharded_grads(cfg, rcfg, mesh, rules)
    _, shards = shd.batch_coordinate(mesh)

    def train_step(params, opt_state, step, batch):
        grads, stats, names = grads_of(params, batch)
        stats = shd.all_reduce_over(stats, mesh, shd.BATCH_AXES) / shards
        gnorm = sharded_global_norm(grads, mesh)
        scale = torch.clamp_max(rcfg.grad_clip / gnorm.clamp_min(1e-12), 1.0)
        for g in grads.values():
            g.to_local().mul_(scale)
        with implicit_replication():
            params, opt_state = opt.update(grads, opt_state, params, step)
        metrics = dict(zip(names, stats[1:]))
        metrics.update(loss=stats[0], grad_norm=gnorm, step=step + 1)
        return params, opt_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, rcfg: RunConfig,
                     opt: Optimizer | None = None, *, seed: int = 0,
                     device="cuda"):
    """(model, params, opt_state): weights drawn on ``device`` from
    ``seed`` in ``rcfg.param_dtype``, and the optimizer's zero state."""
    model = M.init(cfg, seed, getattr(torch, rcfg.param_dtype),
                   device=resolve_device(device))
    params = dict(model.named_parameters())
    return model, params, (opt or make_optimizer(rcfg)).init(params)
