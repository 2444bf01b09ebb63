"""Distributed AAM engine — atomic active messages over ``torch.distributed``.

Vertices are 1-D partitioned into contiguous owner ranges (paper §3.1);
each rank holds its vertex state slice and the edges whose source it
owns.  One *wave* = route all pending messages to their owners and
commit:

  1. bucket messages per destination shard (coalescing, capacity C);
  2. one all-to-all exchanges the coalesced [P, C] buffers;
  3. owners run the commit (any backend of :mod:`repro_torch.core.commit`);
  4. (FR) success flags return to spawners by the reverse all-to-all.

Messages beyond C stay pending and go in the next sub-round.
:func:`run_distributed` executes an :class:`AlgorithmSpec` (an ``init``
hook producing global state and a ``round_fn`` hook emitting one round
of messages through a :class:`WaveRuntime`) and owns partitioning, the
round loop, and the conflict/sub-round telemetry.

This module mirrors :mod:`repro.core.engine`, with these differences:

* One process per shard.  The :class:`repro_torch.launch.mesh.Mesh`
  names the process group, this rank and its device; ``_all_to_all`` is
  ``all_to_all_single`` and ``_psum`` is ``all_reduce`` on that group
  (NCCL on cards, gloo on the CPU).  At world size 1 both return their
  input and no collective runs.
* Each ``lax.while_loop`` is a host loop: a sub-round loop reads one
  psum'd pending count per sub-round, a round loop one ``active`` flag
  per round.  ``DistributedResult.rounds``/``subrounds`` are ints and
  ``delivered_all`` a bool.
* ``backend="auto"`` calibrates once per run on every rank, and rank
  0's policy is broadcast so that every rank commits alike.  The ladder
  level is a Python ``int`` the round loop carries; each round's psum'd
  conflicts and messages move it (one host read per round).
* The round tap (``CommitSpec(trace=True)`` or ``REPRO_TRACE=1``) is a
  host hook: one record per round on each rank, in that rank's
  collector.
* Degraded-mesh mode is a simulation over process groups; see
  :func:`run_distributed`.  ``DistributedResult.shards`` names the shard
  count the run finished on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import autotune as AT
from repro_torch.core import commit as C
from repro_torch.core.coalescing import (BucketPlan, fuse_keys,
                                         gather_from_buckets,
                                         plan_buckets_sorted,
                                         require_key_space,
                                         scatter_to_buckets)
from repro_torch.core.messages import make_messages
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.graphs.csr import Graph, GraphSet, partition_tensors
from repro_torch.obs import trace as OT


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    mesh: Any               # repro_torch.launch.mesh.Mesh; its size is P
    block: int              # vertices per shard
    capacity: int           # coalescing factor C (messages per dest/round)
    axis: str = "data"
    m: int | None = None    # transaction size (None = whole batch)
    op: str = "min"
    spec: C.CommitSpec | None = None   # commit backend; None = coarse(m)
    batch: Any = None       # default batch axis of waves (None = unbatched)
    tuner: AT.TunerPolicy | None = None  # set by run_distributed for "auto"

    @property
    def num_shards(self) -> int:
        return self.mesh.size

    @property
    def commit_spec(self) -> C.CommitSpec:
        if self.spec is not None:
            return self.spec
        return C.CommitSpec(backend="coarse", m=self.m)

    def _commit(self, state, msgs, level=None):
        """Owner-side commit: the calibrated ladder when a tuner policy is
        bound (``backend="auto"``), the static spec otherwise."""
        if self.tuner is not None and level is not None:
            return AT.ladder_commit(state, msgs, self.op, self.tuner, level)
        return C.commit(state, msgs, self.op, self.commit_spec)


def _fused_commit_leaf(ecfg: EngineConfig, st, tgt, payload, lane, base,
                       width, level):
    """Owner-side fused route+commit of one state/payload leaf: the
    calibrated ladder when a tuner policy is bound, the static spec
    otherwise."""
    if ecfg.tuner is not None:
        return AT.ladder_fused_site(st, tgt, payload, ecfg.op, ecfg.tuner,
                                    level, lane=lane, base=base,
                                    width=width)
    return C.fused_commit_site(st, tgt, payload, ecfg.op, ecfg.commit_spec,
                               lane=lane, base=base, width=width)


# ---------------------------------------------------------------------------
# Collectives on the mesh axis
# ---------------------------------------------------------------------------


def _one_shard(mesh) -> bool:
    return mesh.size == 1


def _all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """Tiled all-to-all over dim 0: row block p goes to rank p, and row
    block p of the result came from rank p (``jax.lax.all_to_all(x,
    axis, 0, 0, tiled=True)``).  At world size 1 it returns ``x``."""
    if _one_shard(mesh):
        return x
    import torch.distributed as dist
    send = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=mesh.group)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def _psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over the mesh axis; at world size 1 it returns ``x``."""
    if _one_shard(mesh):
        return x
    import torch.distributed as dist
    out = x.clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def _axis_index(mesh) -> int:
    return mesh.rank


def _all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in rank order."""
    if _one_shard(mesh):
        return x
    import torch.distributed as dist
    send = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(parts, send, group=mesh.group)
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


# ---------------------------------------------------------------------------
# Waves
# ---------------------------------------------------------------------------


def route_wave(ecfg: EngineConfig, state_l, target, payload, pending,
               level=None, major=None, batch=None):
    """One coalescing sub-round (overflow beyond C is not requeued here;
    :func:`wave_until_delivered` does that).

    state_l: tree of [block] local owner slices; payload: matching tree of
    [n] fields; target: [n] global vertex ids; pending: [n] bool; level:
    the ladder index of an ``ecfg.tuner`` commit.
    ``batch``/``major``: a batch axis and [n] int32 item ids.  With
    ``batch.wave_width`` W > 1 (query lanes) the ids ride the exchange,
    state leaves are vertex-major [block * W] slices, and owners commit on
    composite keys ``local_v * W + major``.  With ``backend="fused"`` the
    exchanged buffers go straight into one launch of the fused
    route+commit kernel.  Returns (state_l, kept, success tree,
    conflicts)."""
    P, Cp, mesh = ecfg.num_shards, ecfg.capacity, ecfg.mesh
    batch = batch if batch is not None else ecfg.batch
    width = batch.wave_width if batch is not None else 1
    if width > 1:
        require_key_space(ecfg.block * width,
                          where="route_wave(block * wave_width)")
    owner = target // ecfg.block
    plan, _ = plan_buckets_sorted(owner, pending, P, Cp)
    kept = plan.kept
    # sentinel -1 marks empty slots through the exchange
    buf_t = scatter_to_buckets(plan, torch.where(kept, target, -1), P, Cp,
                               fill=-1)
    buf_p = scatter_to_buckets(plan, payload, P, Cp, fill=0)
    rt_flat = _all_to_all(buf_t, mesh).reshape(-1)
    rp = tree_map(lambda b: _all_to_all(b, mesh), buf_p)
    shard = _axis_index(mesh)
    rl_flat = None
    if width > 1:
        if major is None:
            raise ValueError("batch axis with wave_width > 1 needs "
                             "per-message `major` item ids")
        buf_l = scatter_to_buckets(plan, major.to(torch.int32), P, Cp,
                                   fill=0)
        rl_flat = _all_to_all(buf_l, mesh).reshape(-1)
    valid = rt_flat >= 0
    st_leaves, tdef = tree_flatten(state_l)
    pl_leaves, pdef = tree_flatten(rp)
    if pdef != tdef:
        raise ValueError("state and payload trees differ in structure")
    backend = (ecfg.tuner.backend if ecfg.tuner is not None
               else ecfg.commit_spec.backend)
    fused = [backend == "fused" and C.fused_site_supported(st, p)
             for st, p in zip(st_leaves, pl_leaves)]
    local_idx = None
    if not all(fused):
        local_idx = (rt_flat - shard * ecfg.block).clamp(0, ecfg.block - 1)
        if width > 1:
            local_idx = fuse_keys(local_idx, rl_flat.clamp(0, width - 1),
                                  width)
    new_st, succs = [], []
    conflicts = None
    for i, (st, pl) in enumerate(zip(st_leaves, pl_leaves)):
        if fused[i]:
            res = _fused_commit_leaf(ecfg, st, rt_flat, pl.reshape(-1),
                                     rl_flat, shard * ecfg.block, width,
                                     level)
        else:
            res = ecfg._commit(st, make_messages(local_idx, pl.reshape(-1),
                                                 valid), level)
        new_st.append(res.state)
        if i == 0:
            # slot collisions depend on (target, valid) only, which every
            # payload field shares: count them once per routed message
            conflicts = res.conflicts
        succs.append(res.success)
    # FR return path: one reverse exchange carries every field's flags
    back = _all_to_all(torch.stack(succs, -1).reshape(P, Cp, len(succs)),
                       mesh)
    succ = tree_unflatten(tdef, [gather_from_buckets(back[..., i], plan, Cp,
                                                     fill=False)
                                 for i in range(len(succs))])
    return tree_unflatten(tdef, new_st), kept, succ, conflicts


def _pending_count(pending, mesh) -> int:
    """The psum'd pending count: the sub-round loop's one host read."""
    return int(_psum(pending.sum(dtype=torch.int32), mesh))


def wave_until_delivered(ecfg: EngineConfig, state_l, target, payload,
                         valid, max_subrounds: int = 64, level=None,
                         major=None, batch=None):
    """Deliver all messages: sub-rounds until nothing is pending.

    Returns (state_l, success tree, conflicts, subrounds,
    delivered_all).  ``delivered_all`` is False when ``max_subrounds`` was
    exhausted with messages still pending; callers must surface it.
    ``level`` is the wave's ladder index when ``ecfg.tuner`` is set."""
    n = target.shape[0]
    st_leaves, tdef = tree_flatten(state_l)
    success = [torch.zeros((n,), dtype=torch.bool, device=target.device)
               for _ in st_leaves]
    pending = valid
    conflicts = torch.zeros((), dtype=torch.int32, device=target.device)
    subrounds = 0
    left = _pending_count(pending, ecfg.mesh)
    while left > 0 and subrounds < max_subrounds:
        state_l, kept, succ, cf = route_wave(ecfg, state_l, target, payload,
                                             pending, level, major, batch)
        success = [torch.where(kept, sn, so)
                   for sn, so in zip(tree_flatten(succ)[0], success)]
        pending = pending & ~kept
        conflicts = conflicts + cf
        subrounds += 1
        left = _pending_count(pending, ecfg.mesh)
    # commits run at the owners: the conflict total is the sum over shards
    conflicts = _psum(conflicts, ecfg.mesh)
    return (state_l, tree_unflatten(tdef, success), conflicts, subrounds,
            left == 0)


def route_messages(ecfg: EngineConfig, target, payload, valid):
    """Route one sub-round of messages to owners without committing, for
    custom owner-side handlers.  ``payload`` may be a tree of [n] fields,
    or ``None`` for pure read requests.

    Returns (local_idx [P*C], payload tree of [P*C] or None, rvalid
    [P*C], plan, kept)."""
    P, Cp, mesh = ecfg.num_shards, ecfg.capacity, ecfg.mesh
    owner = target // ecfg.block
    plan, _ = plan_buckets_sorted(owner, valid, P, Cp)
    kept = plan.kept
    buf_t = scatter_to_buckets(plan, torch.where(kept, target, -1), P, Cp,
                               fill=-1)
    rt_flat = _all_to_all(buf_t, mesh).reshape(-1)
    rp_flat = None
    if payload is not None:
        buf_p = scatter_to_buckets(plan, payload, P, Cp, fill=0)
        rp_flat = tree_map(lambda b: _all_to_all(b, mesh).reshape(-1), buf_p)
    local_idx = rt_flat - _axis_index(mesh) * ecfg.block
    return local_idx, rp_flat, rt_flat >= 0, plan, kept


def return_to_spawners(ecfg: EngineConfig, reply, plan: BucketPlan,
                       fill=0):
    """Reverse all-to-all of per-slot replies (FR return path); ``reply``
    may be a tree of [P*C] fields; unkept messages read ``fill``."""
    P, Cp = ecfg.num_shards, ecfg.capacity
    back = tree_map(lambda r: _all_to_all(r.reshape(P, Cp), ecfg.mesh),
                    reply)
    return gather_from_buckets(back, plan, Cp, fill=fill)


def gather_until_answered(ecfg: EngineConfig, arr_l, idx, valid, fill=0,
                          max_subrounds: int = 64):
    """Remote gather: read the distributed array ``arr_l`` (tree of
    [block] owner slices) at global indices ``idx`` [n], requeueing
    coalescing overflow until every valid request is answered.

    Returns (values tree of [n], ``fill`` where ~valid; subrounds;
    delivered_all)."""
    n = idx.shape[0]
    leaves, tdef = tree_flatten(arr_l)
    out = [torch.full((n,), fill, dtype=a.dtype, device=a.device)
           for a in leaves]
    pending = valid
    subrounds = 0
    left = _pending_count(pending, ecfg.mesh)
    while left > 0 and subrounds < max_subrounds:
        local_idx, _, rvalid, plan, kept = route_messages(ecfg, idx, None,
                                                          pending)
        lidx = local_idx.clamp(0, ecfg.block - 1).long()
        reply = [torch.where(rvalid, a[lidx], torch.as_tensor(
            fill, dtype=a.dtype, device=a.device)) for a in leaves]
        back = return_to_spawners(ecfg, tree_unflatten(tdef, reply), plan,
                                  fill=fill)
        out = [torch.where(kept, b, o)
               for b, o in zip(tree_flatten(back)[0], out)]
        pending = pending & ~kept
        subrounds += 1
        left = _pending_count(pending, ecfg.mesh)
    return tree_unflatten(tdef, out), subrounds, left == 0


# ---------------------------------------------------------------------------
# Coalescing-capacity auto-sizing (paper §5.6)
# ---------------------------------------------------------------------------

# ``capacity="auto"``: C starts from the average per-shard inbound load,
# and a process-level feedback cache grows it for the next run whenever a
# run's waves persistently overflowed (sub-rounds per round above
# OVERFLOW_RATIO).  The constants are the reference's.
CAPACITY_MIN = 64
CAPACITY_MAX = 1 << 15
OVERFLOW_RATIO = 2.0
_CAPACITY_CACHE: dict = {}


def auto_capacity(g, num_shards: int) -> int:
    """Current C for (graph shape, shard count): the cached feedback value
    when a previous run reported overflow, else a power of two about
    twice the average per-shard inbound load, clamped."""
    key = (g.num_vertices, g.num_edges, num_shards)
    hit = _CAPACITY_CACHE.get(key)
    if hit is not None:
        return hit
    per_shard = max(1, (2 * g.num_edges) // max(num_shards, 1))
    return max(CAPACITY_MIN, min(1 << (per_shard - 1).bit_length(),
                                 CAPACITY_MAX))


def _capacity_feedback(g, num_shards: int, capacity: int,
                       subrounds: int, rounds: int) -> None:
    """Grow the cached C when waves persistently overflowed this run."""
    if subrounds > OVERFLOW_RATIO * max(rounds, 1) and capacity < CAPACITY_MAX:
        _CAPACITY_CACHE[(g.num_vertices, g.num_edges, num_shards)] = \
            min(capacity * 2, CAPACITY_MAX)


# ---------------------------------------------------------------------------
# The distributed-algorithm harness
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Static shapes of one distributed run (1-D partition, paper §3.1)."""
    num_shards: int
    block: int          # vertices per shard (padded)
    emax: int           # edges per shard (padded)
    num_vertices: int
    num_edges: int

    @property
    def vpad(self) -> int:
        return self.num_shards * self.block


@dataclasses.dataclass
class EdgeSlice:
    """This rank's edge slice (sources owned locally, padded to emax)."""
    src: torch.Tensor      # int32 [emax] global source ids
    dst: torch.Tensor      # int32 [emax] global destination ids
    weight: torch.Tensor   # float32 [emax]
    valid: torch.Tensor    # bool [emax]
    eid: torch.Tensor      # int32 [emax] original edge ids
    my_src: torch.Tensor   # int64 [emax] local row of src (clipped to block);
    #                        int64 because it is only ever an index


class WaveRuntime:
    """Per-round handle the harness passes to ``round_fn``: the wave
    primitives bound to the run's :class:`EngineConfig`, accumulating
    conflicts, sub-rounds, routed messages and the delivery flag over
    every wave and gather of the round."""

    def __init__(self, ecfg: EngineConfig, layout: ShardLayout,
                 max_subrounds: int, level: int | None = None):
        self.ecfg = ecfg
        self.layout = layout
        self.max_subrounds = max_subrounds
        self.level = level          # the tuner's ladder index
        device = ecfg.mesh.device
        self.conflicts = torch.zeros((), dtype=torch.int32, device=device)
        self.subrounds = 0
        self.messages = torch.zeros((), dtype=torch.int32, device=device)
        self.delivered_all = True

    @property
    def shard(self) -> int:
        return _axis_index(self.ecfg.mesh)

    @property
    def gid(self) -> torch.Tensor:
        """Global vertex ids of the local block."""
        return self.shard * self.ecfg.block + torch.arange(
            self.ecfg.block, dtype=torch.int32, device=self.ecfg.mesh.device)

    def psum(self, x):
        return _psum(x, self.ecfg.mesh)

    def any(self, mask) -> torch.Tensor:
        """Global any() over a per-shard bool array."""
        return self.psum(mask.sum(dtype=torch.int32)) > 0

    def wave(self, state_l, target, payload, valid, *, op: str,
             major=None, batch=None):
        """Deliver and commit messages ``(target, payload)`` with ``op``;
        returns (state_l, success tree).  With a ``batch`` axis of
        ``wave_width`` W > 1 the state leaves are vertex-major
        [block * W] slices and ``major`` holds the item ids."""
        ecfg = dataclasses.replace(self.ecfg, op=op)
        state_l, success, cf, sr, dall = wave_until_delivered(
            ecfg, state_l, target, payload, valid, self.max_subrounds,
            self.level, major, batch)
        self.conflicts = self.conflicts + cf
        self.subrounds += sr
        self.messages = self.messages + self.psum(
            valid.sum(dtype=torch.int32))
        self.delivered_all = self.delivered_all and dall
        return state_l, success

    def gather(self, arr_l, idx, valid=None, *, fill=0):
        """Remote gather of the distributed array ``arr_l`` at global
        indices ``idx`` (``fill`` where ~valid)."""
        if valid is None:
            valid = torch.ones(idx.shape, dtype=torch.bool,
                               device=idx.device)
        out, sr, dall = gather_until_answered(
            self.ecfg, arr_l, idx, valid, fill=fill,
            max_subrounds=self.max_subrounds)
        self.subrounds += sr
        self.delivered_all = self.delivered_all and dall
        return out


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    """One irregular algorithm expressed as AAM rounds.

    init:       ``(g, layout) -> (state, scalars)``; ``state`` is a tree of
                global tensors on the mesh's device whose leading dim is
                divisible by ``num_shards``.
    round_fn:   ``(rt, edges, state, scalars, it) -> (state, scalars,
                active)``; ``state`` holds this rank's slices, ``active``
                is the globally consistent flag (False ends the loop).
    max_rounds: ``(g, layout) -> int`` round cap.
    """
    name: str
    message_type: str
    init: Callable[..., Any]
    round_fn: Callable[..., Any]
    max_rounds: Callable[..., int]


@dataclasses.dataclass
class DistributedResult:
    """Harness output: final state and the telemetry the paper tabulates.

    ``delivered_all`` False means some wave hit ``max_subrounds`` with
    messages still pending: the state is not the fixed point."""
    state: Any              # tree of global (padded) tensors
    scalars: Any
    rounds: int
    conflicts: torch.Tensor  # int32, summed over every wave and shard
    subrounds: int
    delivered_all: bool
    m_final: int            # final ladder transaction size M (0 = whole
    #                         batch, -1 = static spec, no tuner)
    capacity: int           # the coalescing factor C the run used
    degraded: bool = False  # True when the run survived a simulated host
    #                         drop (mesh shrink or retry from a snapshot)
    shards: int = 1         # the shard count the run finished on


def telemetry_return(base, res: DistributedResult, telemetry: bool):
    """``telemetry=False``: ``base``; ``telemetry=True``: ``res`` appended
    (a tuple ``base`` gains it at the end, anything else becomes
    ``(base, res)``)."""
    if not telemetry:
        return base
    if isinstance(base, tuple):
        return base + (res,)
    return (base, res)


def _edge_slice(arrays, rank: int, block: int, device) -> EdgeSlice:
    src, dst, w, val, eid = (torch.as_tensor(a[rank]).to(device)
                             for a in arrays)
    return EdgeSlice(src=src, dst=dst, weight=w, valid=val, eid=eid,
                     my_src=(src.long() - rank * block).clamp(0, block - 1))


@dataclasses.dataclass(frozen=True)
class _Carry:
    """What the round loop carries from one round to the next."""
    conflicts: torch.Tensor
    subrounds: int
    delivered_all: bool
    level: int
    rounds: int
    active: bool


def _agree(policy: AT.TunerPolicy, mesh) -> AT.TunerPolicy:
    """Rank 0's calibrated choice, on every rank: each rank times its own
    calibration, and ranks that chose differently would commit
    differently."""
    if _one_shard(mesh):
        return policy
    import torch.distributed as dist
    pick = torch.tensor([C.BACKENDS.index(policy.backend),
                         policy.init_level, int(policy.adaptive)],
                        dtype=torch.int64, device=mesh.device)
    dist.broadcast(pick, src=dist.get_global_rank(mesh.group, 0),
                   group=mesh.group)
    backend, level, adaptive = pick.tolist()
    return dataclasses.replace(policy, backend=C.BACKENDS[backend],
                               init_level=level, adaptive=bool(adaptive))


class _Runner:
    """One round loop over one mesh: the partition and layout, this
    rank's edge slice, the calibrated tuner policy and the round tap.
    ``run`` takes the round cap as an argument, so the same runner serves
    the single-shot run and the chunks of a degraded run."""

    def __init__(self, alg: AlgorithmSpec, mesh, g, *, axis: str,
                 capacity: int, m, spec, batch, max_subrounds: int,
                 edges=None):
        self.alg, self.mesh, self.max_subrounds = alg, mesh, max_subrounds
        self.P = mesh.shape[axis]
        arrays, part = (edges if edges is not None
                        else partition_tensors(g, self.P))
        self.layout = ShardLayout(self.P, part.block, arrays[0].shape[1],
                                  g.num_vertices, g.num_edges)
        ecfg = EngineConfig(mesh, part.block, capacity, axis=axis, m=m,
                            spec=spec, batch=batch)
        self.state0, self.scalars0 = alg.init(g, self.layout)
        self.tuner = None
        if ecfg.commit_spec.backend == C.AUTO:
            # calibration before the loop: a rank's commits see a [block]
            # state slice and up to P*C routed messages a sub-round
            leaf = tree_flatten(self.state0)[0][0]
            like = torch.empty((part.block,), dtype=leaf.dtype,
                               device=mesh.device)
            self.tuner = _agree(AT.policy_for(
                ecfg.commit_spec, like,
                n=min(self.P * capacity, g.num_edges or 1),
                axis_width=batch.race_width if batch is not None else 1),
                mesh)
            ecfg = dataclasses.replace(ecfg, spec=None, tuner=self.tuner)
        self.ecfg = ecfg
        self.max_rounds = int(alg.max_rounds(g, self.layout))
        self.edges = _edge_slice(arrays, _axis_index(mesh), part.block,
                                 mesh.device)
        # the round tap, decided when the run starts
        self.tap = None
        if (spec is not None and spec.trace) or OT.trace_enabled():
            from repro_torch.obs import wavetap
            self.tap = wavetap.round_recorder(alg.name)

    def local(self, state):
        """This rank's slices of a global state tree."""
        rank = _axis_index(self.mesh)
        return tree_map(lambda a: a.reshape(
            (self.P, -1) + tuple(a.shape[1:]))[rank], state)

    def gather(self, state_l):
        """The global state tree, from every rank's slices."""
        return tree_map(lambda a: _all_gather_rows(a, self.mesh), state_l)

    def zero_carry(self) -> _Carry:
        return _Carry(torch.zeros((), dtype=torch.int32,
                                  device=self.mesh.device), 0, True,
                      self.tuner.init_level if self.tuner else 0, 0, True)

    def run(self, state_l, scalars, carry: _Carry, limit: int):
        """Rounds until ``active`` is False or ``limit`` rounds are done."""
        shard = _axis_index(self.mesh)
        while carry.active and carry.rounds < limit:
            rt = WaveRuntime(self.ecfg, self.layout, self.max_subrounds,
                             level=carry.level)
            state_l, scalars, active = self.alg.round_fn(
                rt, self.edges, state_l, scalars, carry.rounds)
            if self.tap is not None:
                self.tap(carry.rounds, rt.conflicts, rt.subrounds,
                         rt.messages, carry.level, shard)
            level = carry.level
            if self.tuner is not None:
                # feedback: this round's psum'd conflicts against routed
                # messages move the ladder alike on every rank
                level = AT.next_level(self.tuner, level, rt.conflicts,
                                      rt.messages)
            carry = _Carry(carry.conflicts + rt.conflicts,
                           carry.subrounds + rt.subrounds,
                           carry.delivered_all and rt.delivered_all, level,
                           carry.rounds + 1, bool(active))
        return state_l, scalars, carry

    def result(self, state, scalars, carry: _Carry, capacity: int,
               degraded: bool) -> DistributedResult:
        m_final = -1
        if self.tuner is not None:
            m_final = self.tuner.ladder[self.tuner.clip(carry.level)] or 0
        return DistributedResult(
            state=state, scalars=scalars, rounds=carry.rounds,
            conflicts=carry.conflicts, subrounds=carry.subrounds,
            delivered_all=carry.delivered_all, m_final=m_final,
            capacity=int(capacity), degraded=degraded, shards=self.P)


def _remap_state(alg: AlgorithmSpec, g, old_layout: ShardLayout,
                 new_layout: ShardLayout, state):
    """Re-home a snapshot's global state onto a smaller mesh.

    The 1-D partition puts vertex v at global index v with padding only
    at the tail, so vertex-state leaves ([vpad, ...]) carry over by
    value: a fresh ``alg.init`` on the new layout supplies the padding
    rows and the first V rows take the snapshot's.  Leaves not shaped by
    vpad (per-edge state: the partition moved under them) cannot be
    re-homed; returns None => restart from round 0."""
    v = g.num_vertices
    fresh, _ = alg.init(g, new_layout)
    old, new = tree_flatten(state)[0], tree_flatten(fresh)
    conforms = all(
        o.dim() >= 1 and o.shape[0] == old_layout.vpad
        and n.shape[0] == new_layout.vpad and o.shape[1:] == n.shape[1:]
        for o, n in zip(old, new[0]))
    if not conforms:
        return None
    return tree_unflatten(new[1], [torch.cat([o[:v], n[v:]])
                                   for o, n in zip(old, new[0])])


# Degraded mode's messages from the original group's rank 0 to the ranks
# that left it: shrink again, the run is done, or the survivors gave up.
_SHRINK, _DONE, _ABORT = 1, 2, 3


def _control(origin, kind: int = 0, size: int = 0) -> tuple[int, int]:
    """Broadcast ``(kind, size)`` from the original group's rank 0 to
    every rank of it (survivors send, ranks that left receive)."""
    import torch.distributed as dist
    msg = torch.tensor([kind, size], dtype=torch.int64, device=origin.device)
    dist.broadcast(msg, src=dist.get_global_rank(origin.group, 0),
                   group=origin.group)
    kind, size = msg.tolist()
    return kind, size


def _share_result(origin, res: DistributedResult | None):
    """Broadcast rank 0's result to every rank of the original group,
    through the host; each rank gets it on its own device."""
    import torch.distributed as dist

    def move(tree, device):
        return tree_map(lambda a: a.to(device)
                        if isinstance(a, torch.Tensor) else a, tree)
    box = [None]
    if res is not None:
        box = [dataclasses.replace(res, state=move(res.state, "cpu"),
                                   scalars=move(res.scalars, "cpu"),
                                   conflicts=res.conflicts.cpu())]
    dist.broadcast_object_list(box, src=dist.get_global_rank(origin.group,
                                                             0),
                               group=origin.group)
    got = box[0]
    return dataclasses.replace(got, state=move(got.state, origin.device),
                               scalars=move(got.scalars, origin.device),
                               conflicts=got.conflicts.to(origin.device))


def _follow(origin) -> DistributedResult:
    """A rank that left the mesh: take part in every later shrink (a
    new process group is made by every process of the job), then return
    the survivors' result."""
    from repro_torch.launch.mesh import sub_mesh
    while True:
        kind, size = _control(origin)
        if kind == _SHRINK:
            sub_mesh(origin, size)
        elif kind == _DONE:
            return _share_result(origin, None)
        else:
            raise RuntimeError("degraded run: the surviving ranks exceeded "
                               "max_faults")


def _run_degraded(alg, g, r: _Runner, kw: dict, *, snapshot_rounds,
                  fault_injector, max_faults: int) -> DistributedResult:
    """The chunked round loop of degraded-mesh mode (see
    :func:`run_distributed`)."""
    from repro_torch.launch.mesh import sub_mesh
    origin = r.mesh
    if origin.size > 1:
        import torch.distributed as dist
        if dist.get_world_size() != origin.size:
            raise ValueError("degraded-mesh mode over several ranks needs "
                             "a mesh over every process of the job (a "
                             "shrink makes a new process group)")
    state, scalars, carry = r.local(r.state0), r.scalars0, r.zero_carry()
    snap = (tree_map(torch.clone, r.state0), scalars, carry)
    chunk = snapshot_rounds if snapshot_rounds else max(r.max_rounds, 1)
    degraded, faults, chunk_i = False, 0, 0
    while carry.active and carry.rounds < r.max_rounds:
        limit = min(carry.rounds + chunk, r.max_rounds)
        try:
            if fault_injector is not None:
                fault_injector(chunk_i, carry.rounds)
            state, scalars, carry = r.run(state, scalars, carry, limit)
            # the round snapshot: every rank gathers the global state
            snap = (tree_map(torch.clone, r.gather(state)), scalars, carry)
        except KeyboardInterrupt:
            raise
        except Exception:
            faults += 1
            if faults > max_faults:
                if r.P < origin.size:
                    _control(origin, _ABORT)
                raise
            degraded = True
            tr = OT.get_tracer()
            if tr.active:
                tr.instant("mesh_shrink", cat="engine",
                           args={"alg": alg.name, "P": r.P,
                                 "survivors": max(r.P - 1, 1),
                                 "rounds_done": carry.rounds,
                                 "faults": faults})
            global_state, scalars, carry = snap      # last whole chunk
            if r.P > 1:
                if r.P < origin.size:
                    _control(origin, _SHRINK, r.P - 1)
                new_mesh = sub_mesh(origin, r.P - 1)
                if new_mesh is None:                 # this rank left
                    return _follow(origin)
                old_layout = r.layout
                r = _Runner(alg, new_mesh, g, **kw)
                remapped = _remap_state(alg, g, old_layout, r.layout,
                                        global_state)
                if remapped is None:
                    # per-edge state cannot be re-homed: restart the
                    # query from round 0 on the surviving mesh
                    global_state, scalars = r.state0, r.scalars0
                    carry = r.zero_carry()
                else:
                    global_state = remapped
            # P == 1: nothing to shrink; retry the snapshot in place
            state = r.local(tree_map(torch.clone, global_state))
        chunk_i += 1
    res = r.result(r.gather(state), scalars, carry, kw["capacity"],
                   degraded)
    if r.P < origin.size:
        _control(origin, _DONE)
        _share_result(origin, res)
    return res


_LINT_CAPTURE = False   # toggled by waverace.capture_algorithms()


class LintCapture(Exception):
    """Carries the normalized (alg, graph, batch) out of
    :func:`run_distributed` when the analyzer only wants the round
    function, not a mesh execution."""

    def __init__(self, alg, g, batch):
        super().__init__(f"lint capture: {alg.name}")
        self.alg, self.g, self.batch = alg, g, batch


def run_distributed(alg: AlgorithmSpec, mesh, g, *,
                    capacity: int | str = 4096,
                    m: int | None = None, axis: str = "data",
                    spec: C.CommitSpec | None = None,
                    max_subrounds: int = 64,
                    edges=None, batch=None,
                    snapshot_rounds: int | None = None,
                    fault_injector=None,
                    max_faults: int = 8) -> DistributedResult:
    """Execute ``alg`` over the ``mesh[axis]`` shards: the one harness
    behind every ``distributed_*`` algorithm.

    Every rank partitions the same graph on the graph's device
    (:func:`repro_torch.graphs.csr.partition_tensors`), keeps its own row
    of edges and its slice of the state ``alg.init`` builds, and runs the
    round loop; the result's ``state`` is the global padded tensors,
    gathered from every rank.  ``capacity``/``m`` are the paper's C and
    M; ``capacity="auto"`` sizes C with :func:`auto_capacity`.  ``edges``
    takes a precomputed ``partition_edges(g, mesh.shape[axis])`` (numpy
    arrays or tensors); ``batch`` is the run's default batch axis.
    ``spec=CommitSpec(backend="auto")`` calibrates once per run (backend
    and ladder seed M*), then each round's psum'd conflicts move the
    transaction size; ``DistributedResult.m_final`` reports where it
    ended.

    ``g`` may be a :class:`repro_torch.graphs.csr.GraphSet`: the run
    executes over its disjoint-union graph, and ``batch`` defaults to
    the set's :class:`~repro_torch.core.coalescing.GraphBatch`.

    **Degraded-mesh mode**, a simulation of a host drop as in the
    reference.  ``snapshot_rounds`` chunks the round loop; at every chunk
    boundary every rank all-gathers the global state as the round
    snapshot.  ``fault_injector(chunk, rounds_done)`` runs on every rank
    before each chunk, with the same arguments, and must raise on all of
    them or on none.  A raise shrinks the mesh by its last rank (a new
    process group over the first P - 1 ranks; every process of the job
    takes part, so the mesh must span the job), re-homes the last
    snapshot onto the smaller layout (:func:`_remap_state`; per-edge
    state restarts from round 0) and finishes there; at P == 1 the chunk
    is retried in place.  The dropped rank leaves the waves, takes part
    in any later shrink, and returns the survivors' final result, which
    rank 0 broadcasts over the original group.  More than ``max_faults``
    faults re-raise on every rank.  ``DistributedResult.degraded`` reports
    a fault, and the ``mesh_shrink`` instant goes to the process tracer.
    With neither parameter set the loop runs single-shot, with no
    snapshot."""
    if isinstance(g, GraphSet):
        batch = batch if batch is not None else g.axis
        g = g.union()
    if _LINT_CAPTURE:
        # repro_torch.analysis.waverace sets this flag, calls the public
        # distributed_* wrappers (so their own state/payload plumbing
        # runs), and catches the normalized (alg, graph, axis) triple
        # here instead of executing the round loop.
        raise LintCapture(alg, g, batch)
    if not isinstance(g, Graph):
        raise NotImplementedError(
            f"run_distributed takes a Graph or a GraphSet, not "
            f"{type(g).__name__}; wrap a list of graphs in GraphSet")
    P = mesh.shape[axis]
    auto_cap = capacity == "auto"
    if auto_cap:
        capacity = auto_capacity(g, P)
    kw = dict(axis=axis, capacity=capacity, m=m, spec=spec, batch=batch,
              max_subrounds=max_subrounds)
    r = _Runner(alg, mesh, g, edges=edges, **kw)
    if snapshot_rounds is not None or fault_injector is not None:
        res = _run_degraded(alg, g, r, kw, snapshot_rounds=snapshot_rounds,
                            fault_injector=fault_injector,
                            max_faults=max_faults)
    else:
        state, scalars, carry = r.run(r.local(r.state0), r.scalars0,
                                      r.zero_carry(), r.max_rounds)
        res = r.result(r.gather(state), scalars, carry, capacity, False)
    if auto_cap:
        _capacity_feedback(g, P, capacity, res.subrounds, res.rounds)
    return res
