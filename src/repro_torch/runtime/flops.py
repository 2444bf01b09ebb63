"""FLOP and byte accounting over recorded ops.

Port of :mod:`repro.runtime.flops`: where the reference walks a jaxpr,
:func:`cost_of` runs the function once under
:class:`repro_torch.analysis.optrace.OpRecorder` and prices each
recorded op:

* ``flops``     — dot products 2·M·N·K (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``mv``, ``dot``; ``convolution`` 2 × output elements ×
  input channels per group × kernel size), pointwise ops one per output
  element, reductions one per input element, gathers, scatters, sorts
  and top-k their output bytes (the reference's O(out) index math);
* ``dot_flops`` — the dot-product share;
* ``bytes``     — the *unfused upper bound*: every op's tensor inputs and
  outputs; views, layout ops and allocations count their output bytes
  only;
* ``by_prim``   — flops by op name, and ``calls`` — ops by name.

The port's four kernel ops (``repro_torch::coarse_commit`` and the rest)
are priced by their modules' ``cost`` rules from the shapes: one combine
per message for the commits, one count per id for the bucket count, and
2·G·L²·(N + P) dot FLOPs for the SSD chunk — the products its plain
version computes with two batched matmuls.

Two differences from the reference are deliberate:

* eager recording counts every loop iteration that ran, where the
  reference counts a ``while`` body once (``repro/runtime/flops.py``,
  ``_multiplier``);
* a kernel op counts its whole grid, where the reference descends into a
  ``pallas_call``'s kernel jaxpr once, which is one grid step.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch

from repro_torch.analysis.optrace import OpRecord, is_scatter, record
from repro_torch.kernels import coalesce, coarse_commit, fused_wave, ssd_chunk


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    dot_flops: float = 0.0
    bytes: float = 0.0
    by_prim: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    calls: dict = dataclasses.field(default_factory=lambda: defaultdict(int))

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.dot_flops += other.dot_flops * mult
        self.bytes += other.bytes * mult
        for k, v in other.by_prim.items():
            self.by_prim[k] += v * mult
        for k, v in other.calls.items():
            self.calls[k] += v


KERNEL_COSTS = {
    "repro_torch::coarse_commit": coarse_commit.cost,
    "repro_torch::fused_route_commit": fused_wave.cost,
    "repro_torch::bucket_count": coalesce.cost,
    "repro_torch::ssd_chunk": ssd_chunk.cost,
}
# layout, movement and allocation: bytes only
_FREE = {
    "aten::cat", "aten::stack", "aten::clone", "aten::copy_",
    "aten::constant_pad_nd", "aten::flip", "aten::roll", "aten::repeat",
    "aten::zeros", "aten::ones", "aten::full", "aten::empty",
    "aten::empty_strided", "aten::zeros_like", "aten::ones_like",
    "aten::full_like", "aten::empty_like", "aten::arange",
    "aten::scalar_tensor", "aten::fill_", "aten::zero_", "aten::tril",
    "aten::triu", "aten::lift_fresh", "aten::lift_fresh_copy",
    "aten::_unsafe_view", "aten::detach", "aten::alias", "aten::contiguous",
}
# host reads: no device work beyond the copy of a scalar
_HOST = {"aten::_local_scalar_dense", "aten::is_nonzero", "aten::item",
         "aten::equal"}
_REDUCE = {
    "aten::sum", "aten::mean", "aten::amax", "aten::amin", "aten::max",
    "aten::min", "aten::any", "aten::all", "aten::argmax", "aten::argmin",
    "aten::prod", "aten::logsumexp", "aten::norm", "aten::linalg_vector_norm",
    "aten::var", "aten::std", "aten::var_mean", "aten::_softmax",
    "aten::_log_softmax", "aten::count_nonzero", "aten::nansum",
}
_MOVE = {
    "aten::index", "aten::gather", "aten::index_select", "aten::take",
    "aten::embedding", "aten::sort", "aten::argsort", "aten::topk",
    "aten::unique_consecutive", "aten::_unique2", "aten::nonzero",
    "aten::masked_select", "aten::searchsorted", "aten::bincount",
    "aten::histc",
}
_DOTS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
         "aten::mv", "aten::addmv", "aten::dot", "aten::convolution"}


def _dot_flops(rec: OpRecord) -> float:
    name, a = rec.name, rec.args
    if name == "aten::convolution":
        out, w = rec.outputs[0], a[1]
        transposed = bool(a[6])
        k = 1
        for d in w.shape[2:]:
            k *= int(d)
        if transposed:      # weight [Cin, Cout/groups, *k]
            return 2.0 * a[0].numel * w.shape[1] * k
        return 2.0 * out.numel * (w.shape[1] * k)
    lhs = a[1] if name in ("aten::addmm", "aten::addmv",
                           "aten::baddbmm") else a[0]
    # out elements x the contracted length (lhs's last dimension)
    return 2.0 * rec.outputs[0].numel * int(lhs.shape[-1])


def _bytes(metas) -> int:
    return sum(t.nbytes for t in metas)


def op_cost(rec: OpRecord) -> Cost:
    """The cost of one recorded op."""
    c = Cost()
    name = rec.name
    c.calls[name] += 1
    out_b, in_b = _bytes(rec.outputs), _bytes(rec.inputs)
    if name in KERNEL_COSTS:
        f, dot, b = KERNEL_COSTS[name](*rec.args)
        c.flops, c.dot_flops, c.bytes = float(f), float(dot), float(b)
        c.by_prim[name] += f
        return c
    if name in _HOST:
        return c
    if name in _DOTS:
        dot = _dot_flops(rec)
        extra = rec.outputs[0].numel if name in (
            "aten::addmm", "aten::addmv", "aten::baddbmm") else 0
        c.flops, c.dot_flops, c.bytes = dot + extra, dot, in_b + out_b
        c.by_prim[name] += dot + extra
        return c
    if rec.view or name in _FREE:
        c.bytes = float(out_b)
        return c
    if name in _REDUCE or torch.Tag.reduction in rec.tags:
        f = sum(t.numel for t in rec.inputs)
    elif name in _MOVE or is_scatter(name):
        f = out_b
    else:
        # pointwise and the rest: one per output element
        f = sum(t.numel for t in rec.outputs)
    c.flops, c.bytes = float(f), float(in_b + out_b)
    c.by_prim[name] += f
    return c


def records_cost(records) -> Cost:
    """The summed cost of recorded ops."""
    total = Cost()
    for rec in records:
        total.add(op_cost(rec))
    return total


def cost_of(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` once, on its inputs' device, and price
    every op it dispatched."""
    _, rec = record(fn, *args, **kwargs)
    return records_cost(rec.records)
