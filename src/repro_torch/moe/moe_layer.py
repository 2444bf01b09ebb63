"""Mixture-of-Experts on Atomic Active Messages.

Port of ``repro.moe.moe_layer``.  A token routed to an expert is an
atomic active message: target = expert, payload = activation, handler =
the expert MLP, combine = a weighted accumulate.  Two dispatch paths:

* ``aam``   — the T·k token→expert assignments are bucketed per expert by
  the coalescing planner (:func:`repro_torch.core.coalescing.
  plan_buckets_sorted`, whose histogram is the hand-written bucket-count
  kernel on a card) into an ``[E, C, d]`` buffer; each token then gathers
  its top-k results back (the FR return path).  The default.
* ``dense`` — GShard-style one-hot dispatch: the oracle.

Both drop over-capacity assignments with the same (arrival-order)
priority, so they agree.  Outside ``"train"`` the capacity is dropless
(C = T·k), so a stepwise decode reproduces the batched forward; in
``"train"`` it is ⌈T·k·capacity_factor/E⌉ rounded up to 8, and what
overflows is dropped.  The train-time expert-parallel path
(``impl="aam_shmap"`` in ``"train"``) is
:func:`repro_torch.moe.shmap_moe.moe_apply_shmap`.

Every step is differentiable: gradients reach the router through the
sorted top-k weights and ``aux_loss``, and the experts through the
bucket scatter and the combine's gather.

On a mesh whose rules split the experts over ``"model"``, each rank holds
E/n of them: the router is gathered whole, so the routing and the bucket
plan (the count kernel on each rank) are the same on every rank of the
group; each rank runs its own experts on their ``[E/n, C, d]`` rows,
combines their weighted outputs, and the partial ``[T, d]`` sums are
summed over the group.  Under sequence parallelism
(:func:`moe_apply_seq`) the layer gathers the sequence in and
reduce-scatters its partial sums back onto each rank's positions.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coalescing import plan_buckets_sorted, scatter_to_buckets
from repro_torch.models.layers import dense_init, gelu
from repro_torch.runtime import sharding as shd


class MoE(nn.Module):
    """``router`` [d, E]; per expert ``wi_gate`` (gated only), ``wi``
    [E, d, ff] and ``wo`` [E, ff, d]."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, *,
                 dtype=torch.float32):
        super().__init__()
        d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        self.router = dense_init((d, e), generator, dtype=dtype)
        if cfg.mlp_gated:
            self.wi_gate = dense_init((e, d, ff), generator, dtype=dtype)
        self.wi = dense_init((e, d, ff), generator, dtype=dtype)
        self.wo = dense_init((e, ff, d), generator, dtype=dtype)


def _route(cfg: ModelConfig, p: MoE, x):
    """x: [T, d] -> (weights [T, k] f32, experts [T, k] int32, router
    probs [T, E] f32).  The top k come from a stable descending sort, so
    equal probabilities go to the lower expert id, as ``lax.top_k``
    breaks ties.  The router is read whole (gathered over ``"model"``
    where the rules split its experts)."""
    router = shd.gather_from_model(p.router, shd.model_shard(p, "router"))
    logits = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    w, e = w[:, :k], e[:, :k]
    w = w / w.sum(-1, keepdim=True)                      # renormalize top-k
    return w, e.to(torch.int32), probs


def _expert_ffn(cfg: ModelConfig, p: MoE, xb, experts=slice(None)):
    """xb: [E', C, d] -> [E', C, d] through the MLPs of ``experts`` (all E
    by default; the expert-parallel path runs its own slice)."""
    h = torch.bmm(xb, p.wi[experts].to(xb.dtype))
    if cfg.mlp_gated:
        g = torch.bmm(xb, p.wi_gate[experts].to(xb.dtype))
        h = F.silu(g) * h
    else:
        h = gelu(h)
    return torch.bmm(h, p.wo[experts].to(xb.dtype))


def _capacity(cfg: ModelConfig, t: int, dropless: bool = False) -> int:
    if dropless:
        # inference: every assignment fits even if all tokens pick one
        # expert, so stepwise decode reproduces the batched forward
        c = t * cfg.experts_per_token
    else:
        c = int(t * cfg.experts_per_token * cfg.capacity_factor
                / cfg.num_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8 lanes


def aux_loss(cfg: ModelConfig, probs, experts):
    """Switch-style load-balancing loss."""
    e = cfg.num_experts
    me = probs.mean(0)                                   # [E]
    # one-hot by comparison: F.one_hot reads the ids' range on the host
    fe = (experts[:, 0, None] == torch.arange(e, device=experts.device)
          ).float().mean(0)
    return e * (me * fe).sum()


def _local_plan(plan, sh, e: int):
    """``plan`` restricted to the experts of ``sh`` (all ``e`` without
    one), with the owners renumbered from 0: the same positions, so the
    same rows in each kept expert."""
    if sh is None:
        return plan, e
    mine = (plan.owner >= sh.start) & (plan.owner < sh.stop)
    return dataclasses.replace(plan, owner=plan.owner - sh.start,
                               kept=plan.kept & mine), sh.stop - sh.start


def _entries(x, sh, sp):
    """(x for the router, x for the experts): the router's compute is the
    same on every rank of the group, the experts' is this rank's.  ``x``
    enters the experts of ``sh`` here, or (under sequence parallelism,
    ``sp``) it entered them in its ``gather_seq`` and the router reads it
    once over the group."""
    if sp is None:
        return x, shd.copy_to_model(x, sh)
    return shd.once_over_model(x, sp), x


def moe_apply_aam(cfg: ModelConfig, p: MoE, x, mode: str = "train",
                  sp=None):
    """AAM dispatch.  x: [T, d] -> (y [T, d], metrics
    ``{"moe_dropped", "moe_aux"}``).  With ``sp`` (see
    :func:`moe_apply_seq`) ``y`` is this rank's experts' partial sum."""
    t, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = _capacity(cfg, t, dropless=mode != "train")
    sh = shd.model_shard(p, "wi")
    x_route, x_experts = _entries(x, sh, sp)
    w, experts, probs = _route(cfg, p, x_route)

    # flatten the T x k assignments into one message batch
    owner = experts.reshape(-1)                          # [T*k]
    token = torch.arange(t, device=x.device).repeat_interleave(k)
    valid = torch.ones(t * k, dtype=torch.bool, device=x.device)
    plan, _ = plan_buckets_sorted(owner, valid, e, cap)

    # coalesced payload: the [E, C, d] activation buffer (this rank's
    # [E/n, C, d] rows on a mesh)
    local, e_local = _local_plan(plan, sh, e)
    xb = scatter_to_buckets(local, x_experts[token], e_local, cap, fill=0)
    xb = shd.logical_constraint(shd.ShardingRules(shd.TRAIN_RULES), xb,
                                ("experts", "expert_capacity", None))
    yb = _expert_ffn(cfg, p, xb)

    mine = experts if sh is None else (  # others are not kept locally
        experts - sh.start).clamp(0, e_local - 1)
    out = _combine(yb, local, mine, shd.copy_to_model(w, sh), cap)
    if sp is None:
        out = shd.reduce_from_model(out, sh)
    return out, {
        "moe_dropped": plan.dropped, "moe_aux": aux_loss(cfg, probs,
                                                         experts)}


def _combine(yb, plan, experts, w, cap: int):
    """The FR return path: each token gathers its k expert outputs from
    ``yb`` [E, C, d] at ``expert * C + position`` and sums them weighted
    by its kept top-k weights (those whose expert ``yb`` holds)."""
    t, k = experts.shape
    e, _, d = yb.shape
    pos = plan.position.reshape(t, k).long()
    kept = plan.kept.reshape(t, k)
    flat = experts.long() * cap + pos.clamp(0, cap - 1)  # [T, k]
    y = yb.reshape(e * cap, d)[flat]                     # [T, k, d]
    wk = torch.where(kept, w, 0.0).to(yb.dtype)
    return torch.einsum("tkd,tk->td", y, wk)


def moe_apply_dense(cfg: ModelConfig, p: MoE, x, mode: str = "train",
                    sp=None):
    """GShard one-hot dispatch (the oracle).  O(T·E·C) memory: small T.
    ``sp`` as in :func:`moe_apply_aam`."""
    t, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = _capacity(cfg, t, dropless=mode != "train")
    sh = shd.model_shard(p, "wi")
    x_route, x_experts = _entries(x, sh, sp)
    w, experts, probs = _route(cfg, p, x_route)

    onehot = F.one_hot(experts.long(), e)                # [T, k, E]
    kth = onehot.sum(1)                                  # [T, E] (0/1)
    pos = torch.cumsum(kth, 0) - kth                     # [T, E] rank
    pos_k = (onehot * pos[:, None, :]).sum(-1)           # [T, k]
    keep_k = pos_k < cap
    poh = F.one_hot(torch.where(keep_k, pos_k, cap), cap + 1)[..., :cap] \
        .to(x.dtype)                                     # [T, k, C]
    oh = onehot.to(x.dtype)
    if sh is not None:                  # this rank's experts
        oh = oh[..., sh.start:sh.stop]
    dmat = torch.einsum("tke,tkc->tec", oh, poh)
    xb = torch.einsum("td,tec->ecd", x_experts, dmat)
    yb = _expert_ffn(cfg, p, xb)
    wmat = torch.einsum("tk,tke,tkc->tec",
                        shd.copy_to_model(w, sh).to(x.dtype), oh, poh)
    out = torch.einsum("ecd,tec->td", yb, wmat)
    if sp is None:
        out = shd.reduce_from_model(out, sh)
    dropped = (t * k - keep_k.sum()).to(torch.int32)
    return out, {"moe_dropped": dropped,
                 "moe_aux": aux_loss(cfg, probs, experts)}


def moe_apply_seq(cfg: ModelConfig, p: MoE, h, sp, impl: str = "aam",
                  mode: str = "train"):
    """The layer under sequence parallelism: ``h`` [B, S/n, d] holds this
    rank's positions ``sp``.  Experts split over ``"model"`` read the
    whole sequence (``gather_seq``: the router and the bucket plan, the
    count kernel among it, run on every token of the rank's batch rows,
    so capacity follows the tokens the layer sees, as without sequence
    parallelism) and their partial sums go back onto each rank's
    positions (``scatter_seq``); experts the fallback left whole run on
    the whole sequence on every rank, and each keeps its positions.
    Returns (y [B, S/n, d], metrics)."""
    b, _, d = h.shape
    if shd.model_shard(p, "wi") is None:
        x = shd.gather_from_model(h, sp)
        y, metrics = moe_apply(cfg, p, x.reshape(-1, d), impl, mode)
        return shd.split_seq(y.reshape(b, -1, d), sp), metrics
    x = shd.gather_seq(h, sp)
    fn = moe_apply_dense if impl == "dense" else moe_apply_aam
    y, metrics = fn(cfg, p, x.reshape(-1, d), mode=mode, sp=sp)
    return shd.scatter_seq(y.reshape(b, -1, d), sp), metrics


def moe_apply(cfg: ModelConfig, p: MoE, x2d, impl: str = "aam",
              mode: str = "train"):
    """``impl``: ``"aam"``, ``"dense"`` or ``"aam_shmap"``.  Inference
    modes are dropless; ``"aam_shmap"`` outside ``"train"`` serves through
    the aam path, as the reference's does (its expert-parallel buffers are
    sized for train capacity)."""
    if impl == "dense":
        return moe_apply_dense(cfg, p, x2d, mode=mode)
    if impl == "aam_shmap" and mode == "train":
        from repro_torch.moe.shmap_moe import moe_apply_shmap
        return moe_apply_shmap(cfg, p, x2d)
    return moe_apply_aam(cfg, p, x2d, mode=mode)
