"""Graph query taxonomy for the serving layer.

A copy of :mod:`repro.serve.queries` (it uses no framework), kept apart
so that the port imports nothing of the JAX package.

A query is one user's question about a registered graph — the unit the
:class:`repro_torch.serve.graph_service.GraphService` admits,
microbatches into lanes of a fused AAM wave, and caches.  Queries are
frozen dataclasses: hashable (result-cache keys, in-flight dedup) and
cheap to compare.

``fuse_key()`` names the static knobs two queries must share to ride the
same fused wave: BFS/SSSP/st-conn queries fuse unconditionally per kind;
personalized-PageRank queries fuse per (iters, damping) pair because
they are constants of the whole wave.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar


@dataclasses.dataclass(frozen=True)
class BfsQuery:
    """Unweighted distances from ``source`` — result row: int32 [V]."""
    source: int
    kind: ClassVar[str] = "bfs"

    def fuse_key(self) -> tuple:
        return (self.kind,)


@dataclasses.dataclass(frozen=True)
class SsspQuery:
    """Weighted distances from ``source`` — result row: float32 [V]."""
    source: int
    kind: ClassVar[str] = "sssp"

    def fuse_key(self) -> tuple:
        return (self.kind,)


@dataclasses.dataclass(frozen=True)
class PprQuery:
    """Personalized PageRank with restart at ``source`` — float32 [V]."""
    source: int
    iters: int = 20
    d: float = 0.85
    kind: ClassVar[str] = "ppr"

    def fuse_key(self) -> tuple:
        return (self.kind, self.iters, self.d)


@dataclasses.dataclass(frozen=True)
class StConnQuery:
    """Is ``t`` reachable from ``s``? — result: bool scalar."""
    s: int
    t: int
    kind: ClassVar[str] = "stconn"

    def fuse_key(self) -> tuple:
        return (self.kind,)


@dataclasses.dataclass(frozen=True)
class ColoringQuery:
    """Boman coloring of the whole graph — result row: int32 [V] colors.

    Coloring has no query-lane form (two colorings of the same graph
    would collide on every vertex), so it fuses on the GRAPH batch axis
    only: one query each over many tenant graphs shares a wave.  The
    seeded coin flips are shared by the wave, so ``seed``/``max_rounds``
    are part of the fuse key."""
    seed: int = 0
    max_rounds: int = 500
    kind: ClassVar[str] = "coloring"

    def fuse_key(self) -> tuple:
        return (self.kind, self.seed, self.max_rounds)


@dataclasses.dataclass(frozen=True)
class MstQuery:
    """Boruvka MST forest of the whole graph — result:
    ``(comp int32 [V], weight, n_edges)``.

    Like coloring, MST is a whole-graph query with no lane form; it
    fuses on the graph batch axis."""
    kind: ClassVar[str] = "mst"

    def fuse_key(self) -> tuple:
        return (self.kind,)


QUERY_KINDS = ("bfs", "sssp", "ppr", "stconn", "coloring", "mst")
# kinds with no query-lane form — servable via the graph batch axis only
GRAPH_ONLY_KINDS = ("coloring", "mst")
# kinds with a lane form — servable on the lanes×graphs PRODUCT axis
# (one wave = many queries × many tenant graphs; see
# repro_torch.serve.product_wave)
PRODUCT_KINDS = tuple(k for k in QUERY_KINDS if k not in GRAPH_ONLY_KINDS)

QUERY_CLASSES = {cls.kind: cls for cls in
                 (BfsQuery, SsspQuery, PprQuery, StConnQuery,
                  ColoringQuery, MstQuery)}


def query_to_dict(q) -> dict:
    """JSON-portable form of a query — what the service snapshot's
    ticket journal and result index store."""
    if q.kind not in QUERY_CLASSES:
        raise ValueError(f"unknown query kind {q.kind!r}")
    return {"kind": q.kind, **dataclasses.asdict(q)}


def query_from_dict(d: dict):
    """Inverse of :func:`query_to_dict` (frozen dataclasses round-trip
    by field dict; hash/equality are value-based, so a rebuilt query
    hits the same cache keys)."""
    d = dict(d)
    cls = QUERY_CLASSES[d.pop("kind")]
    return cls(**d)
