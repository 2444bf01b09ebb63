"""Commit engines — the HTM-transaction analogue.

One semantic operation — "commit a batch of atomic active messages" —
executed by interchangeable mechanisms:

* ``atomic`` — :func:`atomic_commit`: one scatter element per message.
* ``coarse`` — :func:`coarse_commit`: messages are processed in
  "transactions" of M messages; each transaction sorts by target, reduces
  duplicate runs, and writes the state once per distinct target.
* ``pallas`` — the coarse commit kernel
  (:mod:`repro_torch.kernels.coarse_commit`), one tile of ``tile_m``
  messages per transaction.
* ``fused`` — the fused route+commit kernel
  (:mod:`repro_torch.kernels.fused_wave`); through :func:`commit` it takes
  plain local targets, and :func:`fused_commit_site` is the engine's form
  with ``base``, lane ids and ``width``.

:func:`commit` is the single entry point and every backend returns the
same :class:`CommitResult`.  The kernel tiers fall back to ``coarse``
outside the kernels' envelope (1-D int32/float32 state and payload).

Differences from :mod:`repro.core.commit`:

* :class:`CommitSpec` has no ``interpret``: the tensors' device decides.
  On the CPU the kernel tiers run their kernels' plain versions; on a
  card they launch the CUDA kernels.
* ``backend="auto"`` is resolved by :mod:`repro_torch.core.autotune`,
  whose calibration times the tiers on the state's device; the kernel
  tiers join its candidates only on a card.
* ``sanitize`` (or ``REPRO_SANITIZE=1``) replays each commit with its
  messages permuted (:mod:`repro_torch.analysis.sanitize`) and raises
  ``SanitizeError`` at once on a difference.
* Payloads are [n] per message, or vectors: [n, d] into a [V, d] state,
  on ``atomic`` and ``coarse`` — ``add`` at any ``stats``, ``min``/``max``
  at ``stats=False`` (``applied`` counts a message whose row changed in
  any component), ``or`` at ``stats=False`` on the unsorted path only:
  the cases the reference's commit runs; any other raises ``ValueError``.
  The kernels take 1-D int32/float32 state and payload, so a ``pallas``
  or ``fused`` request on a vector payload runs ``coarse``, where the
  reference's ``commit()`` sends it: its dispatch rule, not a fallback
  for a missing kernel.  The kernel tiers cast the payload to the
  state's dtype before the launch.
* Valid messages must target ``[0, V)``: targets outside are dropped on
  every tier (JAX's scatter wraps negative ids instead).
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.core.coalescing import QueryLanes
from repro_torch.core.messages import Messages
from repro_torch.kernels.coarse_commit import coarse_commit_kernel
from repro_torch.kernels.fused_wave import fused_route_commit_kernel
from repro_torch.kernels.ref import fused_keys

OPS = ("min", "max", "add", "or", "first")
BACKENDS = ("atomic", "coarse", "pallas", "fused")
AUTO = "auto"

_INT32_MAX = 2 ** 31 - 1
_REDUCE = {"min": "amin", "max": "amax", "add": "sum", "or": "amax"}


@dataclasses.dataclass
class CommitResult:
    state: torch.Tensor        # updated state [V] (or [V, d])
    success: torch.Tensor      # bool [n] — MF: message won; AS: valid mask
    conflicts: torch.Tensor    # int32 — duplicate-target messages
    applied: torch.Tensor      # int32 — messages that changed state


@dataclasses.dataclass(frozen=True)
class CommitSpec:
    """How to execute a commit — the mechanism, not the semantics.

    backend:  one of :data:`BACKENDS`, or ``"auto"``: the
              :mod:`repro_torch.core.autotune` tuner calibrates the §5.3
              model on the state's device (timed micro-commits) and picks
              the backend and transaction size M*.
    m:        transaction size (messages per transaction); ``None`` = the
              whole batch is one transaction.
    sort:     coalesce by sorting messages by target before resolution
              (``coarse`` tier; ``sort=False`` goes to the scatter path).
    stats:    compute full MF success flags + O(V) telemetry.  ``False``:
              the sorted ``coarse`` tier keeps cheap O(N) conflict/applied
              counters; the scatter path and the kernel tiers report zero.
    tile_m:   kernel transaction tile (used when ``m`` is None).
    block_v:  bound of the ``pallas`` tier's conflict count: targets below
              V padded to ``block_v`` count (the reference kernel's state
              block).
    seed_m:   warm-start hint for ``backend="auto"``: seed the
              conflict-feedback ladder at this transaction size instead of
              the calibrated M* (0 = whole batch); unlike ``m`` it does not
              pin the size.
    sanitize: shadow every commit with a permuted-message-order replay and
              raise :class:`repro_torch.analysis.sanitize.SanitizeError`
              unless the state is reorder-invariant (bit for bit; float
              ``add`` within rtol 2e-4 / atol 1e-6).  ``REPRO_SANITIZE=1``
              turns it on for every spec.
    trace:    record per-commit telemetry (conflicts, applied, routed
              messages, ladder level) through
              :mod:`repro_torch.obs.wavetap`; ``REPRO_TRACE=1`` turns it
              on for every spec.  Off, no tap is installed.
    """
    backend: str = "coarse"
    m: int | None = None
    sort: bool = True
    stats: bool = True
    tile_m: int = 256
    block_v: int = 512
    seed_m: int | None = None
    sanitize: bool = False
    trace: bool = False

    def __post_init__(self):
        if self.m is not None and self.m < 1:
            raise ValueError(f"transaction size m must be >= 1, got {self.m}")
        if self.seed_m is not None and self.seed_m < 0:
            raise ValueError(f"seed_m must be >= 0 (0 = whole batch), "
                             f"got {self.seed_m}")
        if self.tile_m < 1 or self.block_v < 1:
            raise ValueError(f"tile_m/block_v must be >= 1, got "
                             f"{self.tile_m}/{self.block_v}")


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def commit(state: torch.Tensor, msgs: Messages, op: str,
           spec: CommitSpec | None = None) -> CommitResult:
    """Commit a batch of atomic active messages via ``spec.backend``.

    All backends agree on the final state for every op in :data:`OPS`;
    ``success`` masks agree whenever the whole batch is one transaction
    (``m=None``)."""
    spec = spec if spec is not None else CommitSpec()
    if op not in OPS:
        raise ValueError(f"op {op!r} not in {OPS}")
    if spec.backend not in BACKENDS + (AUTO,):
        raise ValueError(f"backend {spec.backend!r} not in "
                         f"{BACKENDS + (AUTO,)}")
    if msgs.capacity == 0:
        z = _zero(state.device)
        return CommitResult(state, torch.zeros((0,), dtype=torch.bool,
                                               device=state.device), z, z)
    if spec.backend == AUTO:
        from repro_torch.core.autotune import resolve_spec   # no cycle
        spec = resolve_spec(spec, state, msgs, op)
    backend = spec.backend
    if backend in ("pallas", "fused") and not _pallas_supported(state, msgs,
                                                                op):
        backend = "coarse"
    if state.dim() != 1 or msgs.payload.dim() != 1:
        _check_vector(state, msgs, op, spec, backend)
    res = _dispatch(state, msgs, op, spec, backend)
    if (spec.sanitize or _sanitize_env()) and msgs.capacity > 1:
        from repro_torch.analysis.sanitize import shadow_check
        shadow_check(state, msgs, op, spec, backend, res.state)
    return res


def _check_vector(state, msgs: Messages, op: str, spec: CommitSpec,
                  backend: str) -> None:
    """Raise unless a vector commit is one the reference's tiers run."""
    if state.shape[1:] != msgs.payload.shape[1:]:
        raise ValueError(f"state rows {tuple(state.shape[1:])} != payload "
                         f"rows {tuple(msgs.payload.shape[1:])}")
    unsorted = backend == "atomic" or not spec.sort
    if op == "add" or (not spec.stats and (
            op in ("min", "max") or (op == "or" and unsorted))):
        return
    raise ValueError(
        f"vector payloads take op 'add', or 'min'/'max' at stats=False "
        f"('or' on the unsorted path), as the reference's commit does; "
        f"got op={op!r}, stats={spec.stats}, backend={backend!r}")


def _bcast(mask, val):
    """``mask`` [n] shaped to broadcast against ``val`` [n, ...]."""
    return mask.reshape(mask.shape + (1,) * (val.dim() - mask.dim()))


def _sanitize_env() -> bool:
    return os.environ.get("REPRO_SANITIZE", "").lower() in (
        "1", "true", "on", "yes")


def _dispatch(state: torch.Tensor, msgs: Messages, op: str,
              spec: CommitSpec, backend: str) -> CommitResult:
    """Backend dispatch with the fallback already resolved, shared by
    :func:`commit` and the sanitizer's replay (which must not re-enter
    :func:`commit`, or it would shadow itself)."""
    if backend == "atomic":
        return atomic_commit(state, msgs, op, stats=spec.stats)
    if backend == "coarse":
        return coarse_commit(state, msgs, op, m=spec.m, sort=spec.sort,
                             stats=spec.stats)
    if backend == "fused":
        return _fused_commit(state, msgs, op, spec)
    return _pallas_commit(state, msgs, op, spec)


def commit_batched(state: torch.Tensor, msgs: Messages, op: str,
                   spec: CommitSpec | None = None, *,
                   axis) -> CommitResult:
    """Commit an axis-fused batch (keys from
    :func:`repro_torch.core.messages.batch_messages`) against the axis's
    flat [axis.flat_size] state: one commit resolves every item's
    conflicts, equal to the looped per-item commits."""
    if state.shape[0] != axis.flat_size:
        raise ValueError(f"state leading dim {state.shape[0]} != "
                         f"axis flat size {axis.flat_size}")
    return commit(state, msgs, op, spec)


def commit_lanes(state: torch.Tensor, msgs: Messages, op: str,
                 spec: CommitSpec | None = None) -> CommitResult:
    """:func:`commit_batched` for the query-lane axis against [L, V]
    lane-major state (keys from ``lane_messages``)."""
    lanes, v = state.shape
    res = commit_batched(state.reshape(lanes * v), msgs, op, spec,
                         axis=QueryLanes(lanes, v))
    return dataclasses.replace(res, state=res.state.reshape(lanes, v))


def commit_product(state: torch.Tensor, msgs: Messages, op: str,
                   spec: CommitSpec | None = None, *,
                   axis) -> CommitResult:
    """:func:`commit_batched` for the lanes×graphs product axis against
    [L, Vtot] lane-major union state (keys from ``product_messages``)."""
    lanes, vtot = state.shape
    if (lanes, vtot) != (axis.lanes, axis.num_vertices):
        raise ValueError(f"state shape {tuple(state.shape)} != product "
                         f"axis ({axis.lanes}, {axis.num_vertices})")
    res = commit_batched(state.reshape(lanes * vtot), msgs, op, spec,
                         axis=axis)
    return dataclasses.replace(res, state=res.state.reshape(lanes, vtot))


_PALLAS_DTYPES = (torch.int32, torch.float32)


def _pallas_supported(state, msgs: Messages, op: str) -> bool:
    payload = msgs.payload
    return (isinstance(payload, torch.Tensor) and payload.dim() == 1
            and state.dim() == 1
            and state.dtype in _PALLAS_DTYPES
            and payload.dtype in _PALLAS_DTYPES)


def _kernel_result(state, new, conflicts, msgs: Messages,
                   op: str) -> CommitResult:
    if op == "first":
        success, _, applied = _first_stats(state, msgs)
    else:
        success, _, applied = _success_stats(state, new, msgs, op)
    return CommitResult(new, success, conflicts, applied)


def _kernel_commit(state, msgs: Messages, op: str, spec: CommitSpec,
                   kernel, **kw) -> CommitResult:
    """A kernel tier through the generic entry: plain local targets, -1 =
    masked, payload cast to the state's dtype."""
    idx = torch.where(msgs.valid, msgs.target, -1)
    val = msgs.payload.to(state.dtype)
    tile_m = spec.m if spec.m is not None else spec.tile_m
    out = kernel(state, idx, val, op=op, tile_m=tile_m, stats=spec.stats,
                 **kw)
    if not spec.stats:
        z = _zero(state.device)
        return CommitResult(out, msgs.valid, z, z)
    return _kernel_result(state, *out, msgs, op)


def _pallas_commit(state, msgs: Messages, op: str,
                   spec: CommitSpec) -> CommitResult:
    return _kernel_commit(state, msgs, op, spec, coarse_commit_kernel,
                          block_v=spec.block_v)


def _fused_commit(state, msgs: Messages, op: str,
                  spec: CommitSpec) -> CommitResult:
    """Generic-entry fused tier: no base/lane, so the kernel's key is the
    target and this matches the pallas tier."""
    return _kernel_commit(state, msgs, op, spec, fused_route_commit_kernel)


def fused_site_supported(state, payload) -> bool:
    """Kernel envelope of the engine's fused fast path: 1-D int32/float32
    state slice, scalar-per-message payload."""
    return (isinstance(payload, torch.Tensor)
            and isinstance(state, torch.Tensor) and state.dim() == 1
            and payload.dim() <= 2
            and state.dtype in _PALLAS_DTYPES
            and payload.dtype in _PALLAS_DTYPES)


def fused_commit_site(state, tgt, payload, op: str, spec: CommitSpec, *,
                      lane=None, base=None, width: int = 1) -> CommitResult:
    """Owner-side fused route+commit: ``tgt``/``payload``/``lane`` are the
    post-exchange buffers (``tgt`` global ids, ``-1`` = empty slot),
    ``base`` the owner's first global vertex id and ``width`` the batch
    axis width.  One kernel launch computes the local keys and commits.

    ``stats=False`` reports ``success = slot occupied``; ``stats=True``
    rebuilds the local keys only for the success/applied accounting."""
    tile_m = spec.m if spec.m is not None else spec.tile_m
    kw = dict(lane=lane, base=base, width=width, op=op, tile_m=tile_m)
    payload = payload.to(state.dtype)
    if not spec.stats:
        new = fused_route_commit_kernel(state, tgt, payload, stats=False,
                                        **kw)
        z = _zero(state.device)
        return CommitResult(new, tgt >= 0, z, z)
    new, conflicts = fused_route_commit_kernel(state, tgt, payload,
                                               stats=True, **kw)
    local, ok = fused_keys(tgt, lane, base, width, state.shape[0] // width)
    msgs = Messages(local.to(torch.int32), payload, ok)
    return _kernel_result(state, new, conflicts, msgs, op)


# ---------------------------------------------------------------------------
# Tier 1: fine-grained baseline (per-message scatter = atomics analogue)
# ---------------------------------------------------------------------------


def _slot(mask, target, v: int) -> torch.Tensor:
    """int64 scatter index: ``target`` where ``mask`` and in range, else
    the sentinel row ``v``."""
    return torch.where(mask & (target >= 0) & (target < v), target,
                       v).long()


def _scatter(state, idx, src, op: str) -> torch.Tensor:
    """``state`` with ``src`` reduced in at ``idx`` (``v`` = dropped);
    rows of a vector state take their message's row."""
    work = state.to(torch.uint8) if state.dtype == torch.bool else state
    buf = torch.cat([work, work.new_zeros((1,) + tuple(work.shape[1:]))])
    buf.scatter_reduce_(0, _bcast(idx, src).expand(src.shape),
                        src.to(work.dtype), _REDUCE[op])
    return buf[:-1].to(state.dtype)


def atomic_commit(state: torch.Tensor, msgs: Messages, op: str,
                  stats: bool = True) -> CommitResult:
    """One scatter element per message; conflicts resolved by scatter
    semantics."""
    if op == "first":
        # first-writer-wins on empty slots (id -1 = empty), ties -> min id
        return _first_commit(state, msgs)
    if op not in _REDUCE:
        raise ValueError(op)
    idx = _slot(msgs.valid, msgs.target, state.shape[0])
    val = msgs.payload
    if op == "add":
        val = torch.where(_bcast(msgs.valid, val), val, torch.zeros_like(val))
    elif op == "or":
        # payload is a truth value: all tiers agree on max(state, val != 0)
        val = val != 0
    new = _scatter(state, idx, val, op)
    if not stats:
        z = _zero(state.device)
        return CommitResult(new, msgs.valid, z, z)
    success, conflicts, applied = _success_stats(state, new, msgs, op)
    return CommitResult(new, success, conflicts, applied)


# ---------------------------------------------------------------------------
# Tier 2: coarse transactions (sort + in-tile conflict resolution)
# ---------------------------------------------------------------------------


def coarse_commit(state: torch.Tensor, msgs: Messages, op: str,
                  m: int | None = None, sort: bool = True,
                  stats: bool = True) -> CommitResult:
    """AAM coarse commit.

    Duplicate targets inside a transaction are reduced to one update per
    distinct target (sort by target + segmented reduce), then committed
    with one conflict-free scatter.  ``m`` is the transaction size: the
    batch runs as ceil(n/m) tiles in order, each tile seeing the state the
    previous ones left.  ``sort=False`` models uncoalesced message streams
    (duplicates go straight to the scatter path)."""
    n = msgs.capacity
    if m is None or m >= n:
        return _resolved_commit(state, msgs, op, sort=sort, stats=stats)
    succ, conflicts, applied = [], _zero(state.device), _zero(state.device)
    for start in range(0, n, m):
        tile = Messages(msgs.target[start:start + m],
                        msgs.payload[start:start + m],
                        msgs.valid[start:start + m])
        r = _resolved_commit(state, tile, op, sort=sort, stats=stats)
        state = r.state
        succ.append(r.success)
        conflicts = conflicts + r.conflicts
        applied = applied + r.applied
    return CommitResult(state, torch.cat(succ), conflicts, applied)


def _resolved_commit(state, msgs: Messages, op: str, sort: bool,
                     stats: bool = True) -> CommitResult:
    """One transaction: resolve in-batch conflicts, then write state.

    Sorted path: stable sort by target, reduce each run of equal targets,
    then ONE scatter of the run results (unique targets).  ``stats=False``
    skips the O(V) success accounting and reports cheap O(N)
    conflict/applied counts (success == valid placeholder)."""
    if op == "first":
        return _first_commit(state, msgs)
    if not sort:
        return atomic_commit(state, msgs, op, stats=stats)
    v = state.shape[0]
    idx = torch.where(msgs.valid, msgs.target, v)
    s_idx, order = torch.sort(idx, stable=True)   # coalescing: sort by target
    s_val = msgs.payload[order]
    s_valid = msgs.valid[order]
    if op == "add":
        s_val = torch.where(_bcast(s_valid, s_val), s_val,
                            torch.zeros_like(s_val))
    elif op == "or":
        s_val = (_bcast(s_valid, s_val) & (s_val != 0)).to(torch.uint8)
    elif s_val.dtype == torch.bool:
        # CUDA has no bool scatter-reduce; min/max of 0/1 are the same on
        # uint8 (the tuner calibrates `min` on a bool state leaf)
        s_val = s_val.to(torch.uint8)

    true1 = torch.ones(1, dtype=torch.bool, device=state.device)
    first = torch.cat([true1, s_idx[1:] != s_idx[:-1]])
    last = torch.cat([first[1:], true1])
    run = torch.cumsum(first, 0) - 1
    red = torch.empty_like(s_val).scatter_reduce_(
        0, _bcast(run, s_val).expand(s_val.shape), s_val, _REDUCE[op],
        include_self=False)
    # one conflict-free write per distinct target (run results at `last`)
    w_idx = _slot(last, s_idx, v)
    new = _scatter(state, w_idx, red[run], op)
    if stats:
        success, conflicts, applied = _success_stats(state, new, msgs, op)
    else:
        conflicts = (s_valid.sum() - (first & s_valid).sum()).to(torch.int32)
        cs = s_idx.clamp(0, v - 1).long()
        changed = new[cs] != state[cs]
        if changed.dim() > 1:     # vector payload: any component changed
            changed = changed.flatten(1).any(1)
        applied = (last & s_valid & changed).sum().to(torch.int32)
        success = msgs.valid
    return CommitResult(new, success, conflicts, applied)


def _first_winner(state, msgs: Messages, rank=None):
    """(winner_rank [V], takes [V]) for first-writer-wins into empty (-1)
    slots; in-batch ties -> lowest message index.

    ``rank`` overrides the per-message tiebreak key (default: position in
    the batch); the sanitizer's permuted replay passes the original
    indices so that the winner does not depend on the order."""
    v = state.shape[0]
    n = msgs.capacity
    rank = (torch.arange(n, dtype=torch.int32, device=state.device)
            if rank is None else torch.as_tensor(
                rank, device=state.device).to(torch.int32))
    winner = torch.full((v + 1,), _INT32_MAX, dtype=torch.int32,
                        device=state.device)
    winner = winner.scatter_reduce_(0, _slot(msgs.valid, msgs.target, v),
                                    rank, "amin")[:v]
    takes = (state < 0) & (winner < n)
    return winner, takes


def _first_stats(state, msgs: Messages):
    """(success, conflicts, applied) of a whole-batch 'first' commit
    against the pre-commit ``state``."""
    v = state.shape[0]
    winner, takes = _first_winner(state, msgs)
    tgt = msgs.target.clamp(0, v - 1).long()
    rank = torch.arange(msgs.capacity, dtype=torch.int32, device=state.device)
    success = msgs.valid & (rank == winner[tgt]) & (state < 0)[tgt]
    n_takes = takes.sum()
    conflicts = msgs.valid.sum() - n_takes
    return success, conflicts.to(torch.int32), n_takes.to(torch.int32)


def _first_commit(state, msgs: Messages) -> CommitResult:
    """First-writer-wins into empty (-1) slots; in-batch ties -> lowest
    message index (the paper's 'one of them succeeds')."""
    n = msgs.capacity
    winner, takes = _first_winner(state, msgs)
    new = torch.where(takes, msgs.payload[winner.clamp(0, n - 1).long()]
                      .to(state.dtype), state)
    success, conflicts, applied = _first_stats(state, msgs)
    return CommitResult(new, success, conflicts, applied)


def _success_stats(old, new, msgs: Messages, op: str):
    n = msgs.capacity
    v = old.shape[0]
    tgt = msgs.target.clamp(0, v - 1).long()
    if op == "add":
        success = msgs.valid
        applied = msgs.valid.sum()
    elif op == "or":
        success = msgs.valid & ~old[tgt].bool()
        applied = (new != old).sum()
    else:  # min/max — MF: message wins iff it set the final value
        final = new[tgt]
        improved = (msgs.payload == final) & (final != old[tgt]) & msgs.valid
        # first among equal winners
        rank = torch.arange(n, dtype=torch.int32, device=old.device)
        first_rank = torch.full((v + 1,), _INT32_MAX, dtype=torch.int32,
                                device=old.device)
        first_rank = first_rank.scatter_reduce_(
            0, _slot(improved, msgs.target, v), rank, "amin")[:v]
        success = improved & (rank == first_rank[tgt])
        applied = (new != old).sum()
    # conflicts = valid messages sharing a target with another message
    counts = torch.zeros(v + 1, dtype=torch.int32, device=old.device)
    counts = counts.scatter_add_(0, _slot(msgs.valid, msgs.target, v),
                                 torch.ones(n, dtype=torch.int32,
                                            device=old.device))[:v]
    conflicts = (msgs.valid & (counts[tgt] > 1)).sum()
    return success, conflicts.to(torch.int32), applied.to(torch.int32)
