"""Carry graphs, messages, commit state, bucket plans, LM weights, gradients
and optimizer state across from host arrays.

The reference package's arrays, taken to numpy (``np.asarray(g.src)``,
...), become the port's objects on a chosen device, so both packages can
compute on the same data.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.coalescing import BucketPlan
from repro_torch.core.messages import Messages
from repro_torch.graphs.csr import Graph, GraphSet, graph_on


def to_graph(indptr, src, dst, weights, num_vertices: int, *,
             device="cuda") -> Graph:
    """A :class:`Graph` from CSR ``indptr`` [V+1] and edge arrays [E]."""
    indptr, src, dst, weights = (np.asarray(a) for a in
                                 (indptr, src, dst, weights))
    if indptr.shape != (num_vertices + 1,):
        raise ValueError(f"indptr shape {indptr.shape} != "
                         f"({num_vertices + 1},)")
    if not src.shape == dst.shape == weights.shape == (int(indptr[-1]),):
        raise ValueError(f"edge arrays {src.shape}/{dst.shape}/"
                         f"{weights.shape} do not match indptr[-1] = "
                         f"{int(indptr[-1])}")
    return graph_on(indptr, src, dst, weights, num_vertices,
                    resolve_device(device))


def to_graphset(members, *, device="cuda") -> GraphSet:
    """A :class:`GraphSet` from a list of ``(indptr, src, dst, weights,
    num_vertices)`` members, each as :func:`to_graph` takes it."""
    device = resolve_device(device)
    return GraphSet([to_graph(*m, device=device) for m in members])


def to_messages(target, payload, valid=None, *, device="cuda") -> Messages:
    """:class:`Messages` from target [n], payload [n] and valid [n]."""
    device = resolve_device(device)
    target = torch.as_tensor(np.asarray(target, np.int32), device=device)
    payload = torch.as_tensor(np.asarray(payload), device=device)
    valid = (torch.ones(target.shape, dtype=torch.bool, device=device)
             if valid is None else
             torch.as_tensor(np.asarray(valid, bool), device=device))
    if not target.shape == payload.shape[:1] == valid.shape:
        raise ValueError(f"target {tuple(target.shape)}, payload "
                         f"{tuple(payload.shape)}, valid "
                         f"{tuple(valid.shape)} disagree")
    return Messages(target=target, payload=payload, valid=valid)


def to_state(state, *, device="cuda") -> torch.Tensor:
    """A commit state tensor (same dtype) from a host array."""
    return torch.as_tensor(np.array(state), device=resolve_device(device))


def to_bucket_plan(owner, position, counts, kept, dropped, *,
                   device="cuda") -> BucketPlan:
    """A :class:`BucketPlan` from its five fields as host arrays: owner,
    position [n] int32, counts [num_buckets] int32, kept [n] bool,
    dropped a 0-d int32."""
    device = resolve_device(device)

    def put(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)
    plan = BucketPlan(owner=put(owner, np.int32),
                      position=put(position, np.int32),
                      counts=put(counts, np.int32), kept=put(kept, bool),
                      dropped=put(dropped, np.int32))
    if not plan.owner.shape == plan.position.shape == plan.kept.shape:
        raise ValueError(f"owner {tuple(plan.owner.shape)}, position "
                         f"{tuple(plan.position.shape)}, kept "
                         f"{tuple(plan.kept.shape)} disagree")
    return plan


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def to_lm_params(cfg, params, *, device="cuda") -> dict[str, torch.Tensor]:
    """The state dict of :class:`repro_torch.models.lm.LM` from the
    reference's LM params (``repro.models.model.init``), leaves as host
    arrays: every leaf of every pattern position (norms, the attention,
    Mamba, dense-MLP and MoE weights) under the same name.  The reference
    stacks each pattern position ``i`` over the blocks:
    ``blocks[i][name][j]`` is layer ``j * len(pattern) + i``."""
    device = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.array(a), device=device)
    out = {f"embed.{k}": put(a) for k, a in _flatten(params["embed"])}
    n = len(cfg.full_pattern)
    if len(params["blocks"]) != n:
        raise ValueError(f"{len(params['blocks'])} pattern positions in "
                         f"params, {n} in {cfg.name}")
    for i, block in enumerate(params["blocks"]):
        for name, a in _flatten(block):
            if a.shape[0] != cfg.num_blocks:
                raise ValueError(f"blocks[{i}].{name} stacks {a.shape[0]} "
                                 f"blocks, {cfg.name} has {cfg.num_blocks}")
            for j in range(cfg.num_blocks):
                out[f"layers.{j * n + i}.{name}"] = put(a[j])
    out.update((k, put(a)) for k, a in _flatten(
        {"final_norm": params["final_norm"]}))
    return out


def to_encdec_params(cfg, params, *,
                     device="cuda") -> dict[str, torch.Tensor]:
    """The state dict of :class:`repro_torch.models.encdec.EncDec` from
    the reference's whisper params (``repro.models.model.init`` of an
    enc-dec config), leaves as host arrays: ``embed``, ``enc_pos``, the
    ``encoder`` and ``decoder`` stacks (``encoder[name][l]`` is encoder
    layer ``l``) and both final norms."""
    device = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.array(a), device=device)
    out = {f"embed.{k}": put(a) for k, a in _flatten(params["embed"])}
    out.update((k, put(a)) for k, a in _flatten(
        {k: params[k] for k in ("enc_pos", "enc_final_norm", "final_norm")}))
    for stack, n in (("encoder", cfg.encoder_layers),
                     ("decoder", cfg.num_layers)):
        for name, a in _flatten(params[stack]):
            if a.shape[0] != n:
                raise ValueError(f"{stack}.{name} stacks {a.shape[0]} "
                                 f"layers, {cfg.name} has {n}")
            for l in range(n):
                out[f"{stack}.{l}.{name}"] = put(a[l])
    return out


def to_params(cfg, tree, *, device="cuda") -> dict[str, torch.Tensor]:
    """:func:`to_encdec_params` for an enc-dec config, else
    :func:`to_lm_params`: any tree shaped like the reference's params (the
    params, a gradient tree, AdamW's ``m`` or ``v``)."""
    conv = to_encdec_params if cfg.encoder_layers else to_lm_params
    return conv(cfg, tree, device=device)


def _expand_shared_vc(tree, n: int):
    """An Adafactor state subtree of stacked leaves with every shared
    ``vc`` (a stacked vector's column factor: its ``vr`` is 1-D)
    broadcast over the ``n`` stacked layers."""
    if isinstance(tree, dict) and "vr" in tree:
        vr, vc = np.asarray(tree["vr"]), np.asarray(tree["vc"])
        if vr.ndim < 2:
            vc = np.broadcast_to(vc, (n,) + vc.shape)
        return {"vr": vr, "vc": vc}
    if isinstance(tree, dict) and "v" in tree:
        return tree
    if isinstance(tree, dict):
        return {k: _expand_shared_vc(v, n) for k, v in tree.items()}
    return [_expand_shared_vc(v, n) for v in tree]


def to_opt_state(cfg, state, *, device="cuda") -> dict:
    """The port's optimizer state from the reference's
    (``repro.train.optimizer``), leaves as host arrays: AdamW's ``{"m",
    "v"}`` map per layer as the params do; Adafactor's per-leaf ``{"vr",
    "vc"}`` or ``{"v"}`` become ``{name: {"vr", "vc"}}`` or ``{name:
    {"v"}}``, each layer taking its slice of a stacked factor and every
    layer of a stacked vector the shared ``vc``."""
    if set(state) == {"m", "v"}:
        return {s: to_params(cfg, state[s], device=device) for s in state}
    state = dict(state)
    if cfg.encoder_layers:
        for stack, n in (("encoder", cfg.encoder_layers),
                         ("decoder", cfg.num_layers)):
            state[stack] = _expand_shared_vc(state[stack], n)
    else:
        state["blocks"] = _expand_shared_vc(state["blocks"], cfg.num_blocks)
    out: dict[str, dict] = {}
    for name, t in to_params(cfg, state, device=device).items():
        param, _, leaf = name.rpartition(".")
        out.setdefault(param, {})[leaf] = t
    return out
