"""Runtime conflict sanitizer: a permuted-message-order commit replay.

HTM guarantees that a batch of atomic active messages commits as if in
*some* serial order; the software commit claims more, that the result
does not depend on the order at all.  The sanitizer checks that claim at
every ``commit()`` call, on the live workload: it replays the batch
through the same backend with the messages in a fixed pseudo-random
permutation and compares the states.

* ``min``/``max``/``or`` and integer ``add``: bit for bit.
* float ``add``: reassociation moves the rounding, so the replay is held
  to :data:`ADD_RTOL`/:data:`ADD_ATOL`.
* ``first``: order-dependent by construction; the shadow re-derives the
  winner with the original message index as the tiebreak (the documented
  rule) from the permuted batch and checks that the shipped positional
  tiebreak picked the same winner.

Enable per call with ``CommitSpec(sanitize=True)`` or everywhere with
``REPRO_SANITIZE=1``.  A mismatch is recorded in :func:`reports` and
raised as :class:`SanitizeError` at once: the port's loops run on the
host, so no device callback stands between the check and the caller.
The permutation, tolerances and report fields are those of
:mod:`repro.analysis.sanitize`.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# float add replay tolerance: one segmented reduction against another with
# a different association order
ADD_RTOL = 2e-4
ADD_ATOL = 1e-6

_PERM_SEED = 0xA51


class SanitizeError(AssertionError):
    """A commit produced an order-dependent result."""


@dataclasses.dataclass(frozen=True)
class SanitizeReport:
    op: str
    backend: str
    capacity: int
    max_abs_err: float
    note: str


_REPORTS: list[SanitizeReport] = []


def reports() -> tuple[SanitizeReport, ...]:
    """Mismatches recorded so far (they survive the raise)."""
    return tuple(_REPORTS)


def clear_reports() -> None:
    _REPORTS.clear()


def _perm(n: int) -> np.ndarray:
    """Fixed permutation of ``range(n)``, deterministic per capacity so
    that sanitized runs are reproducible."""
    return np.asarray(np.random.default_rng(_PERM_SEED).permutation(n),
                      np.int32)


@functools.lru_cache(maxsize=1)
def _device_perm(n: int, device: torch.device) -> torch.Tensor:
    """``_perm(n)`` as int64 indices on ``device``, kept for the last
    capacity: the host takes about a second to draw the permutation of a
    scale-21 round's 63.5 M messages, and a loop commits the same
    capacity round after round."""
    return torch.as_tensor(_perm(n), device=device).long()


def _permute_messages(msgs, perm: torch.Tensor):
    return dataclasses.replace(msgs, target=msgs.target[perm],
                               payload=msgs.payload[perm],
                               valid=msgs.valid[perm])


def _record(ok: bool, err: float, *, op: str, backend: str, capacity: int,
            note: str) -> None:
    if not ok:
        _REPORTS.append(SanitizeReport(op=op, backend=backend,
                                       capacity=capacity, max_abs_err=err,
                                       note=note))
        raise SanitizeError(
            f"commit(op={op!r}, backend={backend!r}, n={capacity}) is "
            f"order-dependent: permuted replay diverges by {err:.3e} "
            f"({note}).  The wave feeding this commit violates the "
            f"reorder-invariance the AAM pipeline assumes.")


def _compare(result, shadow, *, exact: bool) -> tuple[bool, float]:
    """(equal within the op's rule, max |difference|), in one host read."""
    # subtract after the float cast: bool state (`or` waves) has no `-`
    a, b = result.to(torch.float32), shadow.to(torch.float32)
    d = (a - b).abs()
    eq = (result == shadow) if exact else d <= ADD_ATOL + ADD_RTOL * b.abs()
    ok, err = torch.stack([eq.all().to(torch.float32), d.max()]).tolist()
    return bool(ok), err


def _first_shadow(state, msgs, perm: torch.Tensor):
    """Rank-aware replay of a ``first`` commit from the permuted batch:
    the winner's tiebreak key is its original message index, and its
    payload is read from the permuted batch at its permuted position."""
    from repro_torch.core import commit as C
    pm = _permute_messages(msgs, perm)
    n = msgs.capacity
    winner_rank, takes = C._first_winner(state, pm, rank=perm)
    pos = torch.argsort(perm)[winner_rank.clamp(0, n - 1).long()]
    return torch.where(takes, pm.payload[pos].to(state.dtype), state)


def shadow_check(state, msgs, op: str, spec, backend: str, result_state):
    """Replay ``commit(state, msgs, op)`` with permuted messages through
    the same backend and raise :class:`SanitizeError` unless the state is
    unchanged.  Called from :func:`repro_torch.core.commit.commit`; the
    replay dispatches directly and never re-enters it."""
    from repro_torch.core import commit as C
    n = msgs.capacity
    perm = _device_perm(n, state.device)
    if op == "first":
        shadow = _first_shadow(state, msgs, perm)
        exact = True
        note = "rank-aware first replay"
    else:
        pm = _permute_messages(msgs, perm)
        shadow = C._dispatch(state, pm, op, spec, backend).state
        exact = not (op == "add" and state.is_floating_point())
        note = ("permuted replay" if exact
                else f"permuted replay, float add tol rtol={ADD_RTOL}")
    ok, err = _compare(result_state, shadow, exact=exact)
    _record(ok, err, op=op, backend=backend, capacity=n, note=note)
