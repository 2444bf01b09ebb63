"""Explicit expert-parallel MoE dispatch over ``torch.distributed``: port
of ``repro.moe.shmap_moe``.

The owner routing is explicit, like an AAM coalescing round.  The job's
``data × model`` ranks form an :class:`ExpertMesh`: rank ``r`` sits at
data index ``r // model`` and model index ``r % model``.  Tokens are split
over the data index and each rank of a data index holds the same slice
(activations are replicated over the model group), so dispatch moves no
token: every rank selects, from its own slice, the assignments bound for
the ``E / model`` experts it owns (the bucket plan is the coalescing
planner, whose histogram is the bucket-count kernel on a card), runs them,
and one ``all_reduce`` over the model group combines the partial outputs
— the FF&AS commit.  ``moe_dropped`` is summed over every rank and
``moe_aux`` averaged, as the reference's ``psum`` and ``pmean``.  Capacity
is the train capacity of the rank's own T_local tokens, so a rank's
output and drops are those of ``moe_apply_aam`` on its slice.

Each rank holds the whole :class:`~repro_torch.moe.moe_layer.MoE` and runs
its slice of the experts; :func:`place_experts` puts a model's MoE layers
on a mesh, and a layer with no mesh runs the ``aam`` path.

Gradients follow the convention of a loss computed alike on every rank
of a model group: the model-group sum of the outputs and the means of
``moe_aux`` pass their gradient through unchanged, and the gradients of
the tokens and of the top-k weights that enter the local experts are
summed over the model group.  Every gradient is then the same on the
ranks of a model group, except the expert weights', which only their
owner computes.  After the backward, :func:`reduce_expert_grads` does
the reductions the reference's ``shard_map`` autodiff does: it sums the
expert weights' gradients over the model group and averages every
gradient over the data group.  ``make_compressed_dp_step`` knows no
expert mesh (it averages over the one group it is given), so a job on a
``data × model`` mesh with ``model > 1`` reduces with this function.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.coalescing import plan_buckets_sorted, scatter_to_buckets
from repro_torch.moe.moe_layer import (MoE, _capacity, _combine, _expert_ffn,
                                       _route, aux_loss, moe_apply_aam)


@dataclasses.dataclass(frozen=True)
class ExpertMesh:
    """This rank's place in a ``data × model`` job and its two groups:
    ``model_group`` joins the ranks of its data index (they share a token
    slice and split the experts), ``data_group`` those of its model
    index."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Any
    model_group: Any
    device: torch.device


def make_expert_mesh(data: int, model: int, *, device="cuda") -> ExpertMesh:
    """The mesh of this rank in a job of ``data * model`` ranks, after
    ``torch.distributed.init_process_group``.  Every rank calls it with
    the same sizes: it makes all ``data + model`` groups, in one order."""
    device = resolve_device(device)
    import torch.distributed as dist
    world, rank = dist.get_world_size(), dist.get_rank()
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks, the job has {world}")
    d, m = divmod(rank, model)
    groups = [dist.new_group([i * model + j for j in range(model)])
              for i in range(data)]
    model_group = groups[d]
    groups = [dist.new_group([i * model + j for i in range(data)])
              for j in range(model)]
    return ExpertMesh(data, model, d, m, groups[m], model_group, device)


def place_experts(model, mesh: ExpertMesh | None) -> int:
    """Put every MoE layer of ``model`` on ``mesh`` (None takes them off).
    Returns the number of layers placed."""
    layers = [m for m in model.modules() if isinstance(m, MoE)]
    for layer in layers:
        layer.expert_mesh = mesh
    return len(layers)


class _ReduceFwd(torch.autograd.Function):
    """All-reduce (sum, or mean) in the forward; the gradient passes
    through unchanged (the loss downstream is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group, mean: bool):
        import torch.distributed as dist
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group) if mean else y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceBwd(torch.autograd.Function):
    """The identity in the forward; the gradient is summed over ``group``
    (each rank holds only its own experts' part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _sum_ints(x, mesh: ExpertMesh):
    import torch.distributed as dist
    x = x.clone()
    dist.all_reduce(x, group=mesh.model_group)
    dist.all_reduce(x, group=mesh.data_group)
    return x


def reduce_expert_grads(model, mesh: ExpertMesh, grads: dict) -> dict:
    """Reduce the gradients of a backward on ``mesh`` in place: each
    expert weight of a MoE layer of ``model`` placed on ``mesh`` is summed
    over the model group (only its owner computed it), then every
    gradient is averaged over the data group.  ``grads`` maps
    ``model.named_parameters()`` names to gradients; returns it."""
    import torch.distributed as dist
    experts = {f"{prefix}.{name}".lstrip(".")
               for prefix, m in model.named_modules()
               if isinstance(m, MoE) and getattr(m, "expert_mesh",
                                                 None) is mesh
               for name, _ in m.named_parameters() if name != "router"}
    for name, g in grads.items():
        if name in experts:
            dist.all_reduce(g, group=mesh.model_group)
        dist.all_reduce(g, group=mesh.data_group)
        g /= mesh.data
    return grads


def moe_apply_shmap(cfg: ModelConfig, p: MoE, x2d):
    """x2d: [T_local, d], this rank's token slice -> (y [T_local, d],
    metrics ``{"moe_dropped", "moe_aux"}`` over the whole mesh)."""
    mesh = getattr(p, "expert_mesh", None)
    if mesh is None:
        return moe_apply_aam(cfg, p, x2d)
    e, k = cfg.num_experts, cfg.experts_per_token
    if e % mesh.model:
        raise ValueError(f"{e} experts do not split over {mesh.model} "
                         f"model ranks")
    e_local, j = e // mesh.model, mesh.model_rank
    t_local = x2d.shape[0]
    cap = _capacity(cfg, t_local)
    w, experts, probs = _route(cfg, p, x2d)

    # local-owner selection: this rank owns experts [j*e_local, ...)
    owner = experts.reshape(-1) - j * e_local             # [T_local*k]
    token = torch.arange(t_local, device=x2d.device).repeat_interleave(k)
    mine = (owner >= 0) & (owner < e_local)
    plan, _ = plan_buckets_sorted(owner.clamp(0, e_local - 1), mine,
                                  e_local, cap)
    x_mine = _ReduceBwd.apply(x2d, mesh.model_group)
    xb = scatter_to_buckets(plan, x_mine[token], e_local, cap, fill=0)
    yb = _expert_ffn(cfg, p, xb, slice(j * e_local, (j + 1) * e_local))

    # FR return: tokens gather their local-expert outputs (plan.kept holds
    # only this rank's); the model-group sum completes the combine
    eloc = (experts - j * e_local).clamp(0, e_local - 1)
    out = _combine(yb, plan, eloc, _ReduceBwd.apply(w, mesh.model_group),
                   cap)
    out = _ReduceFwd.apply(out, mesh.model_group, False)
    aux = aux_loss(cfg, probs, experts)
    for group in (mesh.model_group, mesh.data_group):
        aux = _ReduceFwd.apply(aux, group, True)
    return out, {"moe_dropped": _sum_ints(plan.dropped, mesh),
                 "moe_aux": aux}
