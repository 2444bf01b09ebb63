"""Bucket histogram: the coalescing router's count.

:func:`bucket_count_kernel` counts owner ids ``owner`` [N] int32 into
``num_buckets`` int32 bins; ids ``< 0`` or ``>= num_buckets`` (``-1`` =
masked) are not counted.  It is the histogram inside
:func:`repro_torch.core.coalescing.plan_buckets_sorted`.

The wrapper calls the dispatched op ``torch.ops.repro_torch.bucket_count``:
on the CPU the plain version
(:func:`repro_torch.kernels.ref.bucket_count_ref`), on a CUDA tensor the
hand-written kernel ``csrc/coalesce.cu`` (warp-reduced atomics into a
shared-memory histogram per block), which launches on the current
stream and does not synchronise.  The op allocates and zeroes the
counts.  Counts are exact, so kernel and plain version are equal.  The op
has integer outputs and no autograd formula; under remat it runs again
in the recompute, one op each time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bucket_count_ref


@torch.library.custom_op("repro_torch::bucket_count", mutates_args=(),
                         device_types="cpu")
def _bucket_count_op(owner: torch.Tensor, num_buckets: int) -> torch.Tensor:
    return bucket_count_ref(owner, num_buckets)


@_bucket_count_op.register_kernel("cuda")
def _bucket_count_cuda(owner, num_buckets):
    counts = torch.zeros(num_buckets, dtype=torch.int32, device=owner.device)
    n = owner.shape[0]
    if n == 0:
        return counts
    lib = _build.load("coalesce")
    err = lib.aam_bucket_count(
        counts.data_ptr(), owner.data_ptr(), n, num_buckets,
        torch.cuda.current_stream(owner.device).cuda_stream)
    _build.check(lib, err, "bucket_count")
    bucket_count_kernel.launches += 1
    return counts


@_bucket_count_op.register_fake
def _(owner, num_buckets):
    return owner.new_empty((num_buckets,), dtype=torch.int32)


def cost(owner, num_buckets, *rest):
    """(flops, dot flops, bytes) of one op: one count per id; the ids
    read once, the counts written once."""
    return owner.shape[0], 0, owner.nbytes + 4 * num_buckets


def bucket_count_kernel(owner, num_buckets: int):
    """owner: [N] int32 -> counts [num_buckets] int32."""
    if num_buckets < 1:
        raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
    if owner.device.type == "cuda":
        if owner.dtype != torch.int32 or owner.dim() != 1:
            raise ValueError(f"owner must be int32 [N], got {owner.dtype} "
                             f"{tuple(owner.shape)}")
        if not owner.is_contiguous():
            raise ValueError("owner must be contiguous")
        if owner.shape[0] >= 2 ** 31:
            raise ValueError(f"{owner.shape[0]} ids: int32 counts take "
                             f"< 2**31")
    elif owner.device.type != "cpu":
        raise ValueError(f"no kernel for device {owner.device}")
    return torch.ops.repro_torch.bucket_count(owner, num_buckets)


bucket_count_kernel.launches = 0
