"""Graph generators: Kronecker (Graph500), Erdős–Rényi, and structural
analogues of the paper's Table-1 SNAP families.

A numpy copy of ``repro.graphs.generators``: given the same seed each
builds the same edge arrays as the reference, then places the graph on
``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graphs.csr import Graph, from_edges


def kronecker(scale: int, edge_factor: int = 16, seed: int = 0,
              a=0.57, b=0.19, c=0.19, *, device="cuda") -> Graph:
    """Graph500 Kronecker generator (power-law degree distribution)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    ab = a + b
    for _ in range(scale):
        r = rng.random(m)
        ii = (r >= ab).astype(np.int64)             # bottom half
        r2 = rng.random(m)
        jj = np.where(ii == 1, (r2 >= c / (1 - ab)).astype(np.int64),
                      (r2 >= a / ab).astype(np.int64))
        src = 2 * src + ii
        dst = 2 * dst + jj
    perm = rng.permutation(n)                       # relabel
    src, dst = perm[src], perm[dst]
    return from_edges(src, dst, n, symmetrize=True, device=device)


def erdos_renyi(n: int, avg_degree: float = 8.0, seed: int = 0, *,
                device="cuda") -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    return from_edges(src, dst, n, symmetrize=True, device=device)


def grid2d(side: int, *, device="cuda") -> Graph:
    """Road-network analogue: 2-D grid (large diameter, degree <= 4)."""
    idx = np.arange(side * side).reshape(side, side)
    s1, d1 = idx[:, :-1].ravel(), idx[:, 1:].ravel()
    s2, d2 = idx[:-1, :].ravel(), idx[1:, :].ravel()
    src = np.concatenate([s1, s2])
    dst = np.concatenate([d1, d2])
    return from_edges(src, dst, side * side, symmetrize=True, device=device)


def preferential(n: int, m_per: int = 4, seed: int = 0, *,
                 device="cuda") -> Graph:
    """Social-network analogue: Barabási–Albert preferential attachment."""
    rng = np.random.default_rng(seed)
    targets = list(range(m_per))
    repeated: list[int] = []
    src_l, dst_l = [], []
    for v in range(m_per, n):
        ts = rng.choice(targets if len(repeated) == 0 else repeated,
                        size=m_per)
        for t in ts:
            src_l.append(v)
            dst_l.append(int(t))
        repeated.extend(ts.tolist())
        repeated.extend([v] * m_per)
        targets.append(v)
    return from_edges(np.array(src_l), np.array(dst_l), n, symmetrize=True,
                      device=device)


def bipartite_web(n: int, hubs: int = 32, avg_degree: float = 6.0,
                  seed: int = 0, *, device="cuda") -> Graph:
    """Web-graph analogue: hub-dominated structure (few very high degree
    vertices + sparse tail)."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree)
    hub_ids = rng.integers(0, hubs, m)
    src = rng.integers(0, n, m)
    dst = np.where(rng.random(m) < 0.7, hub_ids, rng.integers(0, n, m))
    return from_edges(src, dst, n, symmetrize=True, device=device)


def random_weights(g: Graph, seed: int = 0, low=0.1, high=10.0) -> Graph:
    """Attach symmetric random weights (for SSSP / Boruvka); the graph
    stays on its device."""
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst).astype(np.int64)
    key = lo * g.num_vertices + hi
    # same weight for both directions of an undirected edge
    h = (np.abs(np.sin(key * 12.9898 + seed)) * (high - low) + low)
    return dataclasses.replace(
        g, weights=torch.from_numpy(h.astype(np.float32)).to(g.device))


# Table-1 family registry (paper §6.1.2): structurally-matched synthetics.
TABLE1_FAMILIES = {
    "cWT-comm": lambda n, seed=0, device="cuda": bipartite_web(
        n, hubs=max(8, n // 1000), avg_degree=4, seed=seed, device=device),
    "sLV-social": lambda n, seed=0, device="cuda": kronecker(
        max(int(np.log2(max(n, 2))), 4), 14, seed=seed, device=device),
    "sYT-social": lambda n, seed=0, device="cuda": preferential(
        n, 3, seed=seed, device=device),
    "pAM-purchase": lambda n, seed=0, device="cuda": preferential(
        n, 8, seed=seed, device=device),
    "rCA-road": lambda n, seed=0, device="cuda": grid2d(
        int(np.sqrt(n)), device=device),
    "ciP-citation": lambda n, seed=0, device="cuda": erdos_renyi(
        n, 8.0, seed=seed, device=device),
    "wGL-web": lambda n, seed=0, device="cuda": bipartite_web(
        n, hubs=max(8, n // 500), avg_degree=12, seed=seed, device=device),
}
