"""Atomic Active Messages — message taxonomy (paper §3.2).

Two orthogonal criteria classify every message:

* direction of data flow: Fire-and-Forget (FF) vs Fire-and-Return (FR);
* activity commits: Always-Succeed (AS) vs May-Fail (MF).

A :class:`Messages` batch is the unit the runtime coarsens (executes M per
"transaction" tile).  SoA layout of tensors on one device.
:func:`batch_messages` and its lane and product forms fuse many work
items into one batch on composite keys (:mod:`repro_torch.core.coalescing`).
"""
from __future__ import annotations

import dataclasses
import enum

import torch

from repro_torch.core.coalescing import QueryLanes
from repro_torch.core.tree import tree_map


class Direction(enum.Enum):
    FF = "fire_and_forget"
    FR = "fire_and_return"


class CommitMode(enum.Enum):
    AS = "always_succeed"
    MF = "may_fail"


@dataclasses.dataclass(frozen=True)
class MessageType:
    direction: Direction
    commit: CommitMode

    @property
    def tag(self) -> str:
        return f"{'FF' if self.direction is Direction.FF else 'FR'}&" \
               f"{'AS' if self.commit is CommitMode.AS else 'MF'}"


FF_AS = MessageType(Direction.FF, CommitMode.AS)   # PageRank
FF_MF = MessageType(Direction.FF, CommitMode.MF)   # BFS
FR_AS = MessageType(Direction.FR, CommitMode.AS)   # ST-connectivity
FR_MF = MessageType(Direction.FR, CommitMode.MF)   # coloring, Boruvka


@dataclasses.dataclass
class Messages:
    """A batch of atomic active messages.

    target:  int32 [n] destination element id
    payload: [n] operator argument
    valid:   bool [n] — lanes beyond the live count are masked out
    """
    target: torch.Tensor
    payload: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.target.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)


def make_messages(target, payload, valid=None) -> Messages:
    """Messages on the device of ``payload``; ``valid=None`` = all live."""
    payload = torch.as_tensor(payload)
    target = torch.as_tensor(target, device=payload.device).to(torch.int32)
    if valid is None:
        valid = torch.ones(target.shape, dtype=torch.bool,
                           device=target.device)
    valid = torch.as_tensor(valid, device=target.device).to(torch.bool)
    return Messages(target=target, payload=payload, valid=valid)


def batch_messages(axis, major, target, payload, valid) -> Messages:
    """One flat batch on keys ``axis.flatten(major, target)``.

    ``major`` names each message's batch item, ``target`` its per-item
    vertex id (any common shape: everything is flattened); payload is a
    tensor, or a dict/tuple of them, with optional trailing feature dims.
    Committing the result against the [axis.flat_size] flat state
    resolves every item's conflicts in one pass."""
    key = axis.flatten(major, target)
    lead = key.numel()
    return Messages(
        target=key.reshape(-1),
        payload=tree_map(
            lambda x: x.reshape((lead,) + tuple(x.shape[key.dim():])),
            payload),
        valid=torch.as_tensor(valid, device=key.device).to(torch.bool)
        .reshape(-1),
    )


def _lane_ids(target):
    lanes, n = target.shape
    return torch.arange(lanes, dtype=torch.int32,
                        device=target.device)[:, None].expand(lanes, n)


def lane_messages(target, payload, valid, num_vertices: int) -> Messages:
    """The query-lane form of :func:`batch_messages`: an [L, n] lane batch
    fuses on keys ``lane * num_vertices + target``."""
    target = torch.as_tensor(target).to(torch.int32)
    return batch_messages(QueryLanes(target.shape[0], num_vertices),
                          _lane_ids(target), target, payload, valid)


def product_messages(target, payload, valid, axis) -> Messages:
    """The lanes×graphs form of :func:`batch_messages`: an [L, n] batch of
    union-flat targets fuses on keys ``lane * Vtot + target``
    (:class:`repro_torch.core.coalescing.ProductAxis`)."""
    target = torch.as_tensor(target).to(torch.int32)
    return batch_messages(axis, _lane_ids(target), target, payload, valid)


def concat_messages(a: Messages, b: Messages) -> Messages:
    return Messages(
        target=torch.cat([a.target, b.target]),
        payload=torch.cat([a.payload, b.payload]),
        valid=torch.cat([a.valid, b.valid]),
    )
