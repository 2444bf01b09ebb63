"""Carry graphs, messages, commit state and bucket plans across from host
arrays.

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
from repro_torch.graphs.csr import Graph, graph_on


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
