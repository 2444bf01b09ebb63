"""Distributed multi-vertex transactions: the ownership protocol (§4.3).

The paper's protocol: a transaction touching remote vertices CAS-marks
each element's ownership marker, migrates marked elements, and retries
on conflict with random backoff (livelock possible, §5.7).

The adaptation, as in :mod:`repro.core.ownership`: synchronous bidding
rounds.  Every pending transaction bids for all its vertices with a
``min`` commit of its rotating priority key (the CAS analogue: the lowest
bid wins the marker); a transaction that wins every bid applies
atomically this round, the others retry next round.  Rotating priorities
make the protocol deterministic and livelock-free (the globally least
pending transaction always wins all its bids).

Differences from the reference: the round loop is a host loop over the
port's :func:`~repro_torch.core.engine.wave_until_delivered` (one psum'd
pending count a round), and ``TxnStats.retries``/``bids`` are summed over
the ranks, so a run over P ranks reports what one shard holding every
transaction would.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.engine import (EngineConfig, _all_gather_rows,
                                     _axis_index, _psum,
                                     wave_until_delivered)


@dataclasses.dataclass
class TxnStats:
    rounds: int           # rounds until every transaction committed
    retries: int          # total (transaction, round) retry events
    bids: int             # total bid messages sent


def run_transactions(mesh, txns, num_vertices: int, *, axis: str = "data",
                     capacity: int = 2048, max_rounds: int = 1024):
    """``txns``: int32 [P, X, K] global vertex ids, row p the transactions
    of rank p (every rank passes the whole array and uses its own row).
    Applies ``visited |= 1`` to every vertex of every transaction,
    atomically per transaction.  Returns (visited bool [V], TxnStats).

    Keys are ``prio * total + gid`` in int32 with ``total = P * X``
    transactions, so ``total**2`` must stay below 2**31."""
    P = mesh.shape[axis]
    txns = torch.as_tensor(txns)
    if txns.dim() != 3 or txns.shape[0] != P:
        raise ValueError(f"txns shape {tuple(txns.shape)} is not "
                         f"[{P}, X, K]")
    X, K = int(txns.shape[1]), int(txns.shape[2])
    total = P * X
    if total * total >= 2 ** 31:
        raise ValueError(f"{total} transactions: keys prio * total + gid "
                         f"need total**2 < 2**31")
    dev = mesh.device
    block = -(-num_vertices // P)
    ecfg_bid = EngineConfig(mesh, block, capacity, axis=axis, op="min")
    ecfg_apply = EngineConfig(mesh, block, capacity, axis=axis, op="or")
    shard = _axis_index(mesh)
    txn = txns[shard].to(device=dev, dtype=torch.int32)      # [X, K]
    gid = shard * X + torch.arange(X, dtype=torch.int32, device=dev)
    # duplicate vertices inside one transaction bid once (the duplicate
    # lanes succeed: a transaction cannot conflict with itself)
    dup = torch.zeros((X, K), dtype=torch.bool, device=dev)
    for k in range(1, K):
        dup[:, k] = (txn[:, :k] == txn[:, k:k + 1]).any(dim=1)
    targets = txn.reshape(X * K)
    ones = torch.ones((X * K,), dtype=torch.bool, device=dev)
    done = torch.zeros((X,), dtype=torch.bool, device=dev)
    visited = torch.zeros((block,), dtype=torch.bool, device=dev)
    retries = torch.zeros((), dtype=torch.int32, device=dev)
    bids = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    while it < max_rounds and int(_psum((~done).sum(dtype=torch.int32),
                                        mesh)) > 0:
        prio = (gid + it * 1000003) % total
        key = prio * total + gid    # unique, rotating; total**2 < 2**31
        markers = torch.full((block,), 2 ** 30, dtype=torch.int32,
                             device=dev)
        valid = (~done).repeat_interleave(K) & ~dup.reshape(X * K)
        _, success, _, _, _ = wave_until_delivered(
            ecfg_bid, markers, targets, key.repeat_interleave(K), valid)
        granted = success.reshape(X, K) | dup
        win = granted.all(dim=1) & ~done
        # the winners apply atomically (a visited-mark wave)
        visited, _, _, _, _ = wave_until_delivered(
            ecfg_apply, visited, targets, ones, win.repeat_interleave(K))
        retries = retries + (~done & ~win).sum(dtype=torch.int32)
        bids = bids + valid.sum(dtype=torch.int32)
        done = done | win
        it += 1
    all_done, retries, bids = _psum(torch.stack(
        [done.sum(dtype=torch.int32), retries, bids]), mesh).tolist()
    if all_done != total:
        raise AssertionError(f"{all_done} of {total} transactions committed "
                             f"in {max_rounds} rounds")
    visited = _all_gather_rows(visited, mesh)[:num_vertices]
    return visited, TxnStats(rounds=it, retries=retries, bids=bids)
