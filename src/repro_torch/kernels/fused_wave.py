"""Fused route+commit: the ``fused`` tier's kernel.

:func:`fused_route_commit_kernel` is the coarse commit read straight from
post-exchange bucket buffers: global target ids ``tgt`` (``-1`` = empty
slot), optional per-message lane ids and a ``base`` offset.  The kernel
computes ``key = (tgt - base) * width + lane``; a message is valid iff
``tgt >= 0``, ``0 <= tgt - base < nrows`` and, with lanes,
``0 <= lane < width``.  Ops, tiles and the conflict count are those of
:mod:`repro_torch.kernels.coarse_commit`.

The wrapper calls the dispatched op
``torch.ops.repro_torch.fused_route_commit``: on the CPU the plain
version (:func:`repro_torch.kernels.ref.fused_route_commit_ref`), on a
CUDA tensor ``csrc/fused_wave.cu``.  ``base`` may be an int or a device
scalar; the kernel reads it from device memory, so one kernel serves
every shard.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.coarse_commit import (_DTYPES, check_args,
                                               check_cuda_inputs, count_shape,
                                               no_count, pointer, scratch)
from repro_torch.kernels.ref import OPS, fused_route_commit_ref


@torch.library.custom_op("repro_torch::fused_route_commit", mutates_args=(),
                         device_types="cpu")
def _fused_op(state: torch.Tensor, tgt: torch.Tensor, val: torch.Tensor,
              lane: torch.Tensor | None, base: torch.Tensor | None,
              width: int, op: str, tile_m: int,
              stats: bool) -> tuple[torch.Tensor, torch.Tensor]:
    out = fused_route_commit_ref(state, tgt, val, lane=lane, base=base,
                                 width=width, op=op, tile_m=tile_m,
                                 stats=stats)
    return out if stats else (out, no_count(state))


@_fused_op.register_kernel("cuda")
def _fused_cuda(state, tgt, val, lane, base, width, op, tile_m, stats):
    v, n = state.shape[0], tgt.shape[0]
    out, rank, conflicts = scratch(state, op, stats)
    lib = _build.load("fused_wave")
    err = lib.aam_fused_route_commit(
        out.data_ptr(), state.data_ptr(), tgt.data_ptr(), val.data_ptr(),
        pointer(lane), pointer(base), pointer(rank), pointer(conflicts), n,
        v, v // width, width, OPS.index(op), _DTYPES[state.dtype], tile_m,
        int(stats), torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(lib, err, "fused_route_commit")
    fused_route_commit_kernel.launches += 1
    return out, (conflicts[0] if stats else no_count(state))


@_fused_op.register_fake
def _(state, tgt, val, lane, base, width, op, tile_m, stats):
    return count_shape(state, stats)


def cost(state, tgt, val, lane=None, base=None, *rest):
    """(flops, dot flops, bytes) of one op: the key ((tgt - base) *
    width + lane, three operations) and the combine per message; the
    state, ids, lanes and payloads read once, the state written once."""
    lane_bytes = lane.nbytes if lane is not None else 0
    return 4 * tgt.shape[0], 0, (2 * state.nbytes + tgt.nbytes + val.nbytes
                                 + lane_bytes)


def fused_route_commit_kernel(state, tgt, val, *, lane=None, base=None,
                              width: int = 1, op: str = "min",
                              tile_m: int = 256, stats: bool = False):
    """state: [R * width] vertex-major slice; tgt: [N] int32 global ids;
    val: [N]; lane: [N] int32, required iff ``width > 1``; base: global id
    of local row 0 (``None`` = 0).

    Returns the committed state; ``stats=True`` returns ``(state,
    conflicts)``."""
    if (lane is None) == (width > 1):
        raise ValueError(f"lane ids are required iff width > 1 "
                         f"(width={width}, lane="
                         f"{'set' if lane is not None else 'None'})")
    check_args(op, tile_m)
    if state.shape[0] % width:
        raise ValueError(f"state length {state.shape[0]} not divisible by "
                         f"width {width}")
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {state.device}")
    if base is not None:
        base = torch.as_tensor(base, dtype=torch.int32, device=state.device)
        if base.numel() != 1:
            raise ValueError(f"base must be one id, got shape "
                             f"{tuple(base.shape)}")
        base = base.reshape(1).contiguous()
    if state.device.type == "cuda":
        ints = [("tgt", tgt)] + ([("lane", lane)] if lane is not None
                                 else [])
        check_cuda_inputs(state, val, ints, tile_m=tile_m, stats=stats)
    out, conflicts = torch.ops.repro_torch.fused_route_commit(
        state, tgt, val, lane, base, width, op, tile_m, stats)
    return (out, conflicts) if stats else out


fused_route_commit_kernel.launches = 0
