"""Coalescing — bucket messages per destination shard (paper §4.2, §5.6).

Messages are bucketed into a fixed-capacity ``[num_owners, C]`` buffer and
exchanged with one all-to-all per sub-round: C is the coalescing factor.
Overflow beyond capacity is *counted and kept*: the caller requeues the
dropped messages in the next sub-round.

The batch axes share one flat commit-key space among many work items:

* :class:`QueryLanes` (L, V) — L queries over one graph: flat key
  ``lane * V + v``;
* :class:`GraphBatch` (sizes) — one query each over G graphs: flat key
  ``offset[g] + v``;
* :class:`ProductAxis` (L, sizes) — both: ``lane * Vtot + offset[g] + v``.

Items never collide, so one commit over flat keys is exactly the
per-item commits.  This module mirrors :mod:`repro.core.coalescing`;
payloads are tensors or dicts/tuples/lists of them
(:mod:`repro_torch.core.tree`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from repro_torch.core.tree import tree_map
from repro_torch.kernels.coalesce import bucket_count_kernel


@dataclasses.dataclass
class BucketPlan:
    """Routing plan for one coalescing round."""
    owner: torch.Tensor       # int32 [n] destination bucket per message
    position: torch.Tensor    # int32 [n] slot within the bucket (may exceed C)
    counts: torch.Tensor      # int32 [num_buckets] messages per bucket
    kept: torch.Tensor        # bool [n] — within capacity
    dropped: torch.Tensor     # int32 — overflow count (requeued by caller)


# Above this many buckets the dense planner's O(n·num_buckets) one-hot
# dominates memory; the sort-based planner computes the same stable ranks.
DENSE_PLANNER_MAX_BUCKETS = 32

# Largest admissible flat key space for int32 composite keys: commit
# reserves one slot past the state as the drop sentinel, so both the
# sentinel id and the segment count must stay representable.
MAX_FLAT_KEYS = 2 ** 31 - 2


def require_key_space(flat_size: int, *, where: str) -> int:
    """Raise ``OverflowError`` when ``flat_size`` flat keys cannot be
    carried in int32 (``major * stride + minor`` would wrap and items
    would alias each other's state); returns ``flat_size``."""
    flat_size = int(flat_size)
    if flat_size > MAX_FLAT_KEYS:
        raise OverflowError(
            f"{where}: {flat_size} flat keys exceed the int32 key space "
            f"(max {MAX_FLAT_KEYS}; commit needs one extra slot for the "
            f"drop sentinel).  Shrink the batch (fewer lanes/graphs per "
            f"wave).")
    return flat_size


def _int32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32)


def fuse_keys(major, minor, stride: int) -> torch.Tensor:
    """Composite commit key ``major * stride + minor`` (int32).

    Major-major lane state: ``fuse_keys(lane, vertex, V)``; vertex-major
    owner slices: ``fuse_keys(local_vertex, item, W)``."""
    major = _int32(major)
    return major * stride + _int32(minor, major.device)


def split_keys(key, stride: int):
    """Inverse of :func:`fuse_keys`: ``(major, minor)``."""
    key = torch.as_tensor(key)
    return key // stride, key % stride


def fuse_lane_keys(major, minor, stride: int) -> torch.Tensor:
    """The query-lane name of :func:`fuse_keys`."""
    return fuse_keys(major, minor, stride)


def split_lane_keys(key, stride: int):
    """The query-lane name of :func:`split_keys`."""
    return split_keys(key, stride)


@dataclasses.dataclass(frozen=True)
class QueryLanes:
    """Batch axis: L independent queries over one V-vertex graph; flat key
    ``lane * num_vertices + v``."""
    lanes: int
    num_vertices: int

    def __post_init__(self):
        if int(self.lanes) < 1 or int(self.num_vertices) < 1:
            raise ValueError(f"QueryLanes needs lanes/num_vertices >= 1, "
                             f"got {self.lanes}/{self.num_vertices}")
        require_key_space(int(self.lanes) * int(self.num_vertices),
                          where="QueryLanes(L, V)")

    @property
    def flat_size(self) -> int:
        return self.lanes * self.num_vertices

    @property
    def wave_width(self) -> int:
        """Items co-located per vertex in the distributed vertex-major
        layout ([block * lanes] owner slices)."""
        return self.lanes

    @property
    def race_width(self) -> int:
        return self.lanes

    def flatten(self, major, minor) -> torch.Tensor:
        return fuse_keys(major, minor, self.num_vertices)

    def unflatten(self, key):
        return split_keys(key, self.num_vertices)


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Batch axis: one query each over G graphs of ``sizes`` vertices;
    flat key ``offset[g] + v`` (the disjoint-union key space).  Targets
    are already flat, so ``wave_width == 1``."""
    sizes: tuple

    def __post_init__(self):
        if not self.sizes or any(int(s) < 1 for s in self.sizes):
            raise ValueError(f"GraphBatch needs positive per-graph sizes, "
                             f"got {self.sizes}")
        require_key_space(sum(int(s) for s in self.sizes),
                          where="GraphBatch(sizes)")

    @property
    def offsets(self) -> tuple:
        out, acc = [], 0
        for s in self.sizes:
            out.append(acc)
            acc += int(s)
        return tuple(out)

    @property
    def flat_size(self) -> int:
        return sum(int(s) for s in self.sizes)

    @property
    def wave_width(self) -> int:
        return 1        # keys are already globally flat

    @property
    def race_width(self) -> int:
        return len(self.sizes)

    def flatten(self, major, minor) -> torch.Tensor:
        major = torch.as_tensor(major)
        offs = _int32(self.offsets, major.device)
        return offs[major.long()] + _int32(minor, major.device)

    def unflatten(self, key):
        key = _int32(key)
        bounds = _int32(self.offsets[1:] + (self.flat_size,), key.device)
        major = torch.searchsorted(bounds, key, right=True).to(torch.int32)
        offs = _int32(self.offsets, key.device)
        return major, key - offs[major.clamp(0, len(self.sizes) - 1).long()]


@dataclasses.dataclass(frozen=True)
class ProductAxis:
    """Batch axis product: up to L queries over each of G graphs; flat key
    ``lane * Vtot + (offset[g] + v)``, ``Vtot = sum(sizes)``.

    ``ProductAxis(1, sizes).flatten3(0, g, v)`` equals
    ``GraphBatch(sizes).flatten(g, v)``, and
    ``ProductAxis(L, (V,)).flatten3(l, 0, v)`` equals
    ``QueryLanes(L, V).flatten(l, v)``."""
    lanes: int
    sizes: tuple

    def __post_init__(self):
        if int(self.lanes) < 1:
            raise ValueError(f"ProductAxis needs lanes >= 1, got {self.lanes}")
        if not self.sizes or any(int(s) < 1 for s in self.sizes):
            raise ValueError(f"ProductAxis needs positive per-graph sizes, "
                             f"got {self.sizes}")
        require_key_space(int(self.lanes) * sum(int(s) for s in self.sizes),
                          where="ProductAxis(L, sizes): L * Vtot")

    @property
    def graph_axis(self) -> GraphBatch:
        return GraphBatch(self.sizes)

    @property
    def num_graphs(self) -> int:
        return len(self.sizes)

    @property
    def num_vertices(self) -> int:
        """Union vertex count Vtot — the lane stride."""
        return sum(int(s) for s in self.sizes)

    @property
    def offsets(self) -> tuple:
        return self.graph_axis.offsets

    @property
    def flat_size(self) -> int:
        return self.lanes * self.num_vertices

    @property
    def wave_width(self) -> int:
        return self.lanes

    @property
    def race_width(self) -> int:
        return self.lanes * len(self.sizes)

    def flatten(self, major, minor) -> torch.Tensor:
        """(lane, flat union vertex) -> product key."""
        return fuse_keys(major, minor, self.num_vertices)

    def unflatten(self, key):
        return split_keys(key, self.num_vertices)

    def flatten3(self, lane, graph, v) -> torch.Tensor:
        """(lane, graph, local vertex) -> product key."""
        return self.flatten(lane, self.graph_axis.flatten(graph, v))

    def split3(self, key):
        """Inverse of :func:`flatten3`: (lane, graph, local vertex)."""
        lane, flat = self.unflatten(key)
        g, v = self.graph_axis.unflatten(flat)
        return lane, g, v


def plan_buckets(owner, valid, num_buckets: int,
                 capacity: int) -> BucketPlan:
    """Stable bucketing: position = rank of the message within its bucket
    in arrival order.  Dispatches to :func:`plan_buckets_sorted` above
    :data:`DENSE_PLANNER_MAX_BUCKETS`; both planners give identical
    plans.  Valid owners must lie in ``[0, num_buckets)``."""
    if num_buckets > DENSE_PLANNER_MAX_BUCKETS:
        return plan_buckets_sorted(owner, valid, num_buckets, capacity)[0]
    return plan_buckets_dense(owner, valid, num_buckets, capacity)


def plan_buckets_dense(owner, valid, num_buckets: int,
                       capacity: int) -> BucketPlan:
    """The dense one-hot planner (O(n·num_buckets): few buckets)."""
    owner = torch.where(valid, owner, num_buckets).long()
    onehot = torch.nn.functional.one_hot(owner, num_buckets + 1)
    # rank within bucket = exclusive cumsum of the one-hot along messages
    ranks = torch.cumsum(onehot, 0) - onehot
    position = ranks.gather(1, owner[:, None])[:, 0]
    counts = onehot.sum(0)[:num_buckets]
    kept = valid & (position < capacity)
    dropped = valid.sum() - kept.sum()
    return BucketPlan(owner=owner.to(torch.int32),
                      position=position.to(torch.int32),
                      counts=counts.to(torch.int32), kept=kept,
                      dropped=dropped.to(torch.int32))


# Histogram path of plan_buckets_sorted: "pallas" (the bucket-count kernel
# of repro_torch.kernels.coalesce) or "jnp" (torch.bincount).  The names
# are the reference's, so one value drives both packages.
BUCKET_COUNT_ENV = "REPRO_BUCKET_COUNT"
_COUNT_BACKENDS = ("jnp", "pallas")


def _bucket_counts(owner_c, num_buckets: int,
                   count_backend: str | None) -> torch.Tensor:
    """Counts of ``owner_c`` (int32; invalid messages already hold
    ``num_buckets``, which both paths leave out)."""
    backend = count_backend or os.environ.get(BUCKET_COUNT_ENV, "pallas")
    if backend not in _COUNT_BACKENDS:
        raise ValueError(
            f"count_backend={backend!r} not in {_COUNT_BACKENDS}")
    if backend == "pallas":
        return bucket_count_kernel(owner_c, num_buckets)
    return torch.bincount(owner_c, minlength=num_buckets + 1)[:num_buckets]


def plan_buckets_sorted(owner, valid, num_buckets: int, capacity: int,
                        count_backend: str | None = None,
                        ) -> tuple[BucketPlan, torch.Tensor]:
    """Sort-based planner (O(n log n)).  Returns ``(plan, sort_order)``.

    ``count_backend`` selects the histogram: ``"pallas"``, the
    bucket-count kernel (on a CUDA tensor the hand-written kernel, on the
    CPU its plain version), or ``"jnp"``, ``torch.bincount``.  Unset, it
    falls back to ``$REPRO_BUCKET_COUNT`` and then to ``"pallas"`` (the
    reference defaults to ``"jnp"``); counts are exact either way, so the
    plans are identical."""
    n = owner.shape[0]
    owner_c = torch.where(valid, owner, num_buckets).to(torch.int32)
    order = torch.argsort(owner_c, stable=True)
    sorted_owner = owner_c[order]
    counts = _bucket_counts(owner_c, num_buckets, count_backend)
    starts = torch.cat([counts.new_zeros(1),
                        torch.cumsum(counts, 0)])[:num_buckets + 1]
    pos_sorted = (torch.arange(n, dtype=torch.int32, device=owner.device)
                  - starts[sorted_owner.clamp(0, num_buckets).long()]
                  .to(torch.int32))
    position = torch.empty(n, dtype=torch.int32, device=owner.device)
    position[order] = pos_sorted
    kept = valid & (position < capacity)
    dropped = valid.sum() - kept.sum()
    return BucketPlan(owner=owner_c, position=position,
                      counts=counts.to(torch.int32), kept=kept,
                      dropped=dropped.to(torch.int32)), order


# Slots past the [num_buckets * capacity] buffer that unkept messages are
# written to and then cut off; spread so that no one address takes them all.
_SPILL = 1024


def scatter_to_buckets(plan: BucketPlan, payload: Any, num_buckets: int,
                       capacity: int, fill=0) -> Any:
    """Build the ``[num_buckets, capacity, ...]`` coalesced buffer of each
    field of ``payload``; empty slots hold ``fill``."""
    n = plan.owner.shape[0]
    body = num_buckets * capacity
    spill = body + (torch.arange(n, device=plan.owner.device) % _SPILL)
    flat = torch.where(plan.kept,
                       plan.owner.long() * capacity + plan.position.long(),
                       spill)

    def scat(x):
        buf = torch.full((body + _SPILL,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        buf[flat] = x
        return buf[:body].reshape((num_buckets, capacity)
                                  + tuple(x.shape[1:]))
    return tree_map(scat, payload)


def bucket_message_ids(plan: BucketPlan, num_buckets: int,
                       capacity: int) -> torch.Tensor:
    """``[num_buckets, capacity]`` original message index per slot (-1
    empty)."""
    ids = torch.arange(plan.owner.shape[0], dtype=torch.int32,
                       device=plan.owner.device)
    return scatter_to_buckets(plan, ids + 1, num_buckets, capacity,
                              fill=0) - 1


def gather_from_buckets(buf: Any, plan: BucketPlan, capacity: int,
                        fill=0) -> Any:
    """Inverse of :func:`scatter_to_buckets`: each message's slot value
    (``fill`` where not kept) — the FR return path."""
    pos = torch.where(plan.kept, plan.position, 0).long()

    def gat(x):
        nb, cap = x.shape[0], x.shape[1]
        flatx = x.reshape((nb * cap,) + tuple(x.shape[2:]))
        idx = (plan.owner.long().clamp(0, nb - 1) * cap
               + pos.clamp(0, cap - 1))
        out = flatx[idx]
        mask = plan.kept.reshape(plan.kept.shape + (1,) * (out.dim() - 1))
        return torch.where(mask, out, fill)
    return tree_map(gat, buf)
