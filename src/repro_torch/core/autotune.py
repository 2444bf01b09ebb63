"""Per-round commit handle for the single-shard wave loops.

Only the static-spec branch of ``repro.core.autotune.make_commit_step``
is ported; the calibrating tuner (``backend="auto"``, the M ladder, the
persistent cache) and the arguments that size its calibration are
ROADMAP Queue 1 item 4.
"""
from __future__ import annotations

import torch

from repro_torch.core.commit import CommitSpec, commit


def make_commit_step(spec: CommitSpec | None, op: str, state, msgs_like=None,
                     *, n: int | None = None, axis_width: int = 1,
                     label: str | None = None):
    """Returns ``(step, level0)`` where ``step(state, msgs, level) ->
    (CommitResult, level')``.  For a static spec the level is a dummy the
    loop carries through unchanged.  ``msgs_like``, ``n``, ``axis_width``
    and ``label`` size and name the tuner's calibration in the reference;
    the static branch takes them and ignores them."""
    level0 = torch.zeros((), dtype=torch.int32, device=state.device)

    def step(state, msgs, level, _spec=spec):
        return commit(state, msgs, op, _spec), level

    return step, level0
