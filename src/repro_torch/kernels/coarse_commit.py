"""Coarse conflict-resolving commit: the ``pallas`` tier's kernel.

:func:`coarse_commit_kernel` commits N messages ``(idx, val)`` into a 1-D
int32 or float32 state: ``min``, ``max``, ``add``, ``or`` (``max(state,
val != 0)``) or ``first`` (each slot empty, ``< 0``, in the input state
takes the payload of its lowest-index message; payloads non-negative).
One ``tile_m`` tile of messages is one transaction; ``stats=True`` also
returns the number of messages whose target occurs more than once in
their tile.

The wrapper checks its arguments and calls the dispatched op
``torch.ops.repro_torch.coarse_commit``, so that an op recorder
(:mod:`repro_torch.analysis.optrace`) sees one launch as one op.  On the
CPU the op runs the plain version
(:func:`repro_torch.kernels.ref.coarse_commit_ref`); on a CUDA tensor it
runs the hand-written kernel ``csrc/coarse_commit.cu``, which launches on
the current stream, does not synchronise and allocates nothing (the op
allocates the output, the rank scratch for ``first`` and the counter for
``stats=True``, and nothing else).  The op writes a fresh output and
returns ``(state, conflicts)``, ``conflicts`` empty without ``stats``.
The kernel combines messages to one target in a shared-memory table of
each CTA before they reach device memory (``csrc/commit_tiles.cuh``).
Its conflict count sorts each tile in shared memory, so with
``stats=True`` it takes ``tile_m`` up to :data:`MAX_STATS_TILE`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import OPS, RANK_INF, coarse_commit_ref

MAX_STATS_TILE = 16384     # commit_tiles.cuh: 128 KiB of shared memory
_DTYPES = {torch.int32: 0, torch.float32: 1}


def check_args(op: str, tile_m: int) -> None:
    if op not in OPS:
        raise ValueError(f"op {op!r} not in {OPS}")
    if tile_m < 1:
        raise ValueError(f"tile_m must be >= 1, got {tile_m}")


def check_cuda_inputs(state, val, int_arrays, *, tile_m: int, stats: bool):
    """Raise on what the CUDA kernels do not take."""
    if state.dtype not in _DTYPES:
        raise TypeError(f"state dtype {state.dtype} not in int32/float32")
    if val.dtype != state.dtype:
        raise TypeError(f"payload dtype {val.dtype} != state dtype "
                        f"{state.dtype}")
    n = val.shape[0]
    for name, t in (("state", state), ("val", val), *int_arrays):
        if t.device != state.device:
            raise ValueError(f"{name} on {t.device}, state on {state.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be 1-D and contiguous")
    for name, t in int_arrays:
        if t.dtype != torch.int32 or t.shape[0] != n:
            raise ValueError(f"{name} must be int32 [{n}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if n >= RANK_INF:
        raise ValueError(f"batch of {n} messages: the kernels take < 2**30")
    if stats and tile_m > MAX_STATS_TILE:
        raise ValueError(f"tile_m={tile_m} with stats=True exceeds the "
                         f"kernel's shared-memory limit of {MAX_STATS_TILE}")


def scratch(state, op: str, stats: bool):
    """(out, rank, conflicts) for a kernel call: the output; the rank
    scratch only for ``first``; the conflict counter, zeroed, only with
    ``stats`` (``None`` where unused, so no fill is launched for it)."""
    out = torch.empty_like(state)
    rank = (torch.empty(state.shape[0], dtype=torch.int32,
                        device=state.device) if op == "first" else None)
    conflicts = (torch.zeros(1, dtype=torch.int32, device=state.device)
                 if stats else None)
    return out, rank, conflicts


def pointer(t):
    """``t``'s device pointer, or ``None`` (a null pointer) for no
    tensor."""
    return None if t is None else t.data_ptr()


def no_count(state):
    """The ops' conflict output without ``stats``: an empty int32 tensor
    (no allocation, no launch)."""
    return torch.empty(0, dtype=torch.int32, device=state.device)


def count_shape(state, stats: bool):
    """Shape-only outputs of a commit op, for ``register_fake``."""
    return (torch.empty_like(state),
            state.new_empty(() if stats else (0,), dtype=torch.int32))


@torch.library.custom_op("repro_torch::coarse_commit", mutates_args=(),
                         device_types="cpu")
def _coarse_commit_op(state: torch.Tensor, idx: torch.Tensor,
                      val: torch.Tensor, op: str, tile_m: int, block_v: int,
                      stats: bool) -> tuple[torch.Tensor, torch.Tensor]:
    out = coarse_commit_ref(state, idx, val, op=op, tile_m=tile_m,
                            block_v=block_v, stats=stats)
    return out if stats else (out, no_count(state))


@_coarse_commit_op.register_kernel("cuda")
def _coarse_commit_cuda(state, idx, val, op, tile_m, block_v, stats):
    v, n = state.shape[0], idx.shape[0]
    out, rank, conflicts = scratch(state, op, stats)
    lib = _build.load("coarse_commit")
    err = lib.aam_coarse_commit(
        out.data_ptr(), state.data_ptr(), idx.data_ptr(), val.data_ptr(),
        pointer(rank), pointer(conflicts), n, v, -(-v // block_v) * block_v,
        OPS.index(op), _DTYPES[state.dtype], tile_m, int(stats),
        torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(lib, err, "coarse_commit")
    coarse_commit_kernel.launches += 1
    return out, (conflicts[0] if stats else no_count(state))


@_coarse_commit_op.register_fake
def _(state, idx, val, op, tile_m, block_v, stats):
    return count_shape(state, stats)


def cost(state, idx, val, *rest):
    """(flops, dot flops, bytes) of one op: a combine per message; the
    state, ids and payloads read once, the state written once."""
    return idx.shape[0], 0, 2 * state.nbytes + idx.nbytes + val.nbytes


def coarse_commit_kernel(state, idx, val, *, op: str = "min",
                         tile_m: int = 256, block_v: int = 512,
                         stats: bool = False):
    """state: [V]; idx: [N] int32 (-1 = masked); val: [N].

    Returns the committed state; with ``stats=True`` returns ``(state,
    conflicts)``, ``conflicts`` an int32 0-d tensor.  ``block_v`` only
    sets the bound up to which targets are counted (V padded to
    ``block_v``, as in the reference kernel)."""
    check_args(op, tile_m)
    if block_v < 1:
        raise ValueError(f"block_v must be >= 1, got {block_v}")
    if state.device.type == "cuda":
        check_cuda_inputs(state, val, [("idx", idx)], tile_m=tile_m,
                          stats=stats)
    elif state.device.type != "cpu":
        raise ValueError(f"no kernel for device {state.device}")
    out, conflicts = torch.ops.repro_torch.coarse_commit(
        state, idx, val, op, tile_m, block_v, stats)
    return (out, conflicts) if stats else out


coarse_commit_kernel.launches = 0
