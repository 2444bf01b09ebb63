"""Fused route+commit: the ``fused`` tier's kernel.

:func:`fused_route_commit_kernel` is the coarse commit read straight from
post-exchange bucket buffers: global target ids ``tgt`` (``-1`` = empty
slot), optional per-message lane ids and a ``base`` offset.  The kernel
computes ``key = (tgt - base) * width + lane``; a message is valid iff
``tgt >= 0``, ``0 <= tgt - base < nrows`` and, with lanes,
``0 <= lane < width``.  Ops, tiles and the conflict count are those of
:mod:`repro_torch.kernels.coarse_commit`.

A tensor on the CPU goes to the plain version
(:func:`repro_torch.kernels.ref.fused_route_commit_ref`); a CUDA tensor
goes to ``csrc/fused_wave.cu``.  ``base`` may be an int or a device
scalar; the kernel reads it from device memory, so one kernel serves
every shard.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.coarse_commit import (_DTYPES, check_args,
                                               check_cuda_inputs, pointer,
                                               scratch)
from repro_torch.kernels.ref import OPS, fused_route_commit_ref


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
    v, n = state.shape[0], tgt.shape[0]
    if v % width:
        raise ValueError(f"state length {v} not divisible by width {width}")
    if state.device.type == "cpu":
        return fused_route_commit_ref(state, tgt, val, lane=lane, base=base,
                                      width=width, op=op, tile_m=tile_m,
                                      stats=stats)
    if state.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.device}")
    ints = [("tgt", tgt)] + ([("lane", lane)] if lane is not None else [])
    if base is not None:
        base = torch.as_tensor(base, dtype=torch.int32, device=state.device)
        if base.numel() != 1:
            raise ValueError(f"base must be one id, got shape "
                             f"{tuple(base.shape)}")
        base = base.reshape(1).contiguous()
    check_cuda_inputs(state, val, ints, tile_m=tile_m, stats=stats)
    out, rank, conflicts = scratch(state, op, stats)
    lib = _build.load("fused_wave")
    err = lib.aam_fused_route_commit(
        out.data_ptr(), state.data_ptr(), tgt.data_ptr(), val.data_ptr(),
        pointer(lane), pointer(base), pointer(rank), pointer(conflicts), n,
        v, v // width, width, OPS.index(op), _DTYPES[state.dtype], tile_m,
        int(stats), torch.cuda.current_stream(state.device).cuda_stream)
    _build.check(lib, err, "fused_route_commit")
    fused_route_commit_kernel.launches += 1
    return (out, conflicts[0]) if stats else out


fused_route_commit_kernel.launches = 0
