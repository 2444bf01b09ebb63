"""Plain PyTorch versions of the port's kernels.

The two commit kernels' versions give the same committed state and the
same per-tile conflict count as their CUDA kernels
(``csrc/coarse_commit.cu``, ``csrc/fused_wave.cu``) and as the Pallas
kernels of the reference; :func:`bucket_count_ref` gives the same counts
as ``csrc/coalesce.cu``; :func:`ssd_chunk_ref` is the SSD intra-chunk
block of ``csrc/ssd_chunk.cu`` up to f32 rounding.  The kernel wrappers
run these for tensors on the CPU; the tests and ``chip_smoke.py`` hold
the kernels against them.  ``scatter_reduce`` into a buffer with a sentinel row at
index V stands in for JAX's ``FILL_OR_DROP`` scatter mode.
"""
from __future__ import annotations

import torch

RANK_INF = 2 ** 30      # int32 rank sentinel: batches hold < 2**30 messages
OPS = ("min", "max", "add", "or", "first")

_REDUCE = {"min": "amin", "max": "amax", "or": "amax"}


def _apply(state, key, ok, val, op: str):
    """Commit the messages with ``ok`` set into ``state`` (keys in [0, V)).

    ``first``: each slot that is empty (``< 0``) in ``state`` takes the
    payload of its lowest-index message; payloads are non-negative."""
    v = state.shape[0]
    safe = torch.where(ok, key, v).long()
    if op == "first":
        n = key.shape[0]
        empty = torch.cat([state < 0, state.new_zeros(1, dtype=torch.bool)])
        rank = torch.arange(n, dtype=torch.int32, device=state.device)
        safe = torch.where(empty[safe], safe, v)
        win = torch.full((v + 1,), RANK_INF, dtype=torch.int32,
                         device=state.device)
        win = win.scatter_reduce_(0, safe, rank, "amin")[:v]
        takes = win < RANK_INF
        return torch.where(takes, val[win.clamp(max=n - 1)].to(state.dtype),
                           state)
    buf = torch.cat([state, state.new_zeros(1)])
    if op == "add":
        return buf.scatter_add_(0, safe, val.to(state.dtype))[:v]
    src = (val != 0).to(state.dtype) if op == "or" else val.to(state.dtype)
    return buf.scatter_reduce_(0, safe, src, _REDUCE[op])[:v]


def _tile_conflicts(key, counted, tile_m: int, bound: int):
    """Messages whose key occurs more than once within their tile of
    ``tile_m`` consecutive messages, over the messages with ``counted``
    set (keys in [0, bound))."""
    tile = torch.arange(key.shape[0], dtype=torch.int64,
                        device=key.device) // tile_m
    comp = (tile * bound + key.long())[counted]
    if comp.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=key.device)
    _, counts = torch.unique(comp, return_counts=True)
    return counts[counts > 1].sum().to(torch.int32)


def coarse_commit_ref(state, idx, val, *, op: str = "min", tile_m: int = 256,
                      block_v: int = 512, stats: bool = False):
    """Plain version of the coarse commit kernel.

    state: [V]; idx: [N] int32 (-1 = masked); val: [N].  Returns the
    committed state, or ``(state, conflicts)`` with ``stats=True``.  As in
    the reference kernel, conflicts count targets up to the state length
    padded to ``block_v``; only targets below V are committed."""
    v, n = state.shape[0], idx.shape[0]
    if n == 0 or v == 0:
        zero = torch.zeros((), dtype=torch.int32, device=state.device)
        return (state.clone(), zero) if stats else state.clone()
    new = _apply(state, idx, (idx >= 0) & (idx < v), val, op)
    if not stats:
        return new
    bound = -(-v // block_v) * block_v
    return new, _tile_conflicts(idx, (idx >= 0) & (idx < bound), tile_m,
                                bound)


def fused_keys(tgt, lane, base, width: int, nrows: int):
    """(key, ok): the fused kernel's composite key
    ``(tgt - base) * width + lane`` and its validity mask."""
    rel = tgt if base is None else tgt - base
    ok = (tgt >= 0) & (rel >= 0) & (rel < nrows)
    if lane is None:
        return torch.where(ok, rel, 0), ok
    ok = ok & (lane >= 0) & (lane < width)
    return torch.where(ok, rel * width + lane, 0), ok


def fused_route_commit_ref(state, tgt, val, *, lane=None, base=None,
                           width: int = 1, op: str = "min",
                           tile_m: int = 256, stats: bool = False):
    """Plain version of the fused route+commit kernel: keys are computed
    from global ids ``tgt`` (``-1`` = empty slot), ``base`` and ``lane``."""
    v, n = state.shape[0], tgt.shape[0]
    if n == 0 or v == 0:
        zero = torch.zeros((), dtype=torch.int32, device=state.device)
        return (state.clone(), zero) if stats else state.clone()
    key, ok = fused_keys(tgt, lane, base, width, v // width)
    new = _apply(state, key, ok, val, op)
    if not stats:
        return new
    return new, _tile_conflicts(key, ok, tile_m, v)


def bucket_count_ref(owner, num_buckets: int):
    """Plain version of the bucket-count kernel: messages per bucket.

    owner: [N] int32; ids ``< 0`` or ``>= num_buckets`` (``-1`` = masked)
    are not counted.  Returns int32 [num_buckets]."""
    valid = (owner >= 0) & (owner < num_buckets)
    safe = torch.where(valid, owner, num_buckets).long()
    counts = torch.zeros(num_buckets + 1, dtype=torch.int32,
                         device=owner.device)
    counts.scatter_add_(0, safe, torch.ones_like(safe, dtype=torch.int32))
    return counts[:num_buckets]


def ssd_chunk_ref(C, B, x, a):
    """Plain version of the SSD intra-chunk kernel, batched over G cells.

    C, B: [G, L, N]; x: [G, L, P]; a: [G, L] log-decays.  With
    ``cs = cumsum(a)``, ``y[t] = sum_{s<=t} (C_t.B_s) exp(cs_t - cs_s) x_s``,
    accumulated in f32 and returned in ``x.dtype``.  ``cs`` is summed in
    f64 and rounded to f32, as the kernel does: at ``|cs|`` near 250 two f32
    summation orders move a decay by up to 1e-3.  The mask is applied before
    the product, since ``exp`` of an entry with ``s > t`` may be inf."""
    f32 = torch.float32
    L = a.shape[-1]
    cs = torch.cumsum(a.to(torch.float64), dim=-1).to(f32)
    tri = torch.ones(L, L, dtype=torch.bool, device=a.device).tril()
    decay = torch.where(tri, torch.exp(cs[:, :, None] - cs[:, None, :]), 0.0)
    gram = torch.bmm(C.to(f32), B.to(f32).transpose(1, 2)) * decay
    return torch.bmm(gram, x.to(f32)).to(x.dtype)
