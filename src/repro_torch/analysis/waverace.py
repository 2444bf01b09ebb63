"""Wave-race detection over recorded ops.

An HTM transaction aborts when another core touches its read/write set;
our software rounds have no such tripwire — a round that scatters into
a state array OUTSIDE ``commit()``'s conflict resolution while also
reading it produces silently order-dependent results (the classic
in-wave read race the paper's Table 2 "conflicting access" aborts would
have caught in hardware).

Port of :mod:`repro.analysis.waverace`.  Where the reference traces a
round to a jaxpr and walks it, this runs one round eagerly under
:class:`repro_torch.analysis.optrace.OpRecorder` and walks the record:

* the *state chain* starts at the storages of the round's state leaves
  and grows through views, pointwise ops (``torch.Tag.pointwise``, in
  place too) and the copies in :data:`ALIAS_OPS`, and through the
  outputs of writes into chained tensors;
* every ``commit()`` (and ``fused_commit_site``) runs under
  :func:`repro_torch.core.commit.commit_scope`, which each record
  carries;
* a scatter-class write (:func:`~repro_torch.analysis.optrace.
  is_scatter`: ``scatter*``,
  ``index_put*``, ``index_add*``, ``index_copy*``, ``index_reduce*``,
  ``masked_scatter*``, ``put*``, in place or not) whose operand is on the
  chain **outside** the scope is a finding, and so is one of the four
  kernel ops (:data:`KERNEL_OPS`) called outside the scope with a
  chained operand: a raw state write that bypasses conflict resolution.
  Unscoped gathers (:data:`GATHER_OPS`) of chained tensors are the read
  half of the race (evidence, not findings).

``commits`` counts the commit scopes in which the round wrote (a
scatter-class write or a kernel op, into any tensor), so a round whose
waves commit into fresh buffers (Boruvka's selections, PageRank's
accumulator) still shows its commits; the reference counts only scoped
scatters whose operand is on its chain.  ``kernel_commits`` counts the
scoped kernel ops, one per launch on a card.

Round steps come from two seams, as in the reference:

* :func:`capture_algorithms` calls every public ``distributed_*`` /
  ``batched_over_graphs_*`` wrapper on a tiny graph with
  ``repro_torch.core.engine._LINT_CAPTURE`` set; :class:`~repro_torch.
  core.engine.LintCapture` carries out the normalized ``(alg, graph,
  batch)``;
* :func:`repro_torch.serve.product_wave.lint_traceables` exposes the
  three ``ProductWave`` chunk bodies as state-only callables.

A round runs against :class:`LintRuntime`, a single-shard ``WaveRuntime``
stand-in whose ``wave`` is a plain ``commit()`` on the same composite
keys.  Beyond the reference: ``spec=`` picks the commit tier (any of the
four; the reference fixes ``atomic``) and ``device=`` where the round
runs, so on a card the kernel tiers launch their kernels inside the
recorded rounds.  A check keeps the sanitizer's environment replay off
and takes static specs only, so that no calibration or shadow commit
enters the record.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import torch

from repro_torch.analysis.optrace import OpRecorder, is_scatter
from repro_torch.core import engine as E
from repro_torch.core.coalescing import fuse_keys
from repro_torch.core.commit import AUTO, CommitSpec, commit
from repro_torch.core.messages import make_messages
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten

# copies whose output carries its input's values: the chain goes through
ALIAS_OPS = {
    "aten::clone", "aten::_to_copy", "aten::copy", "aten::copy_",
    "aten::cat", "aten::stack", "aten::flip", "aten::roll", "aten::repeat",
    "aten::constant_pad_nd", "aten::where", "aten::masked_fill",
    "aten::masked_fill_", "aten::_unsafe_view", "aten::lift_fresh_copy",
}
# kernel-launch state writes: the four hand-written kernels as dispatched
# ops — the same rule as the scatters
KERNEL_OPS = {"repro_torch::coarse_commit", "repro_torch::fused_route_commit",
              "repro_torch::bucket_count", "repro_torch::ssd_chunk"}
# state reads
GATHER_OPS = {"aten::index", "aten::gather", "aten::index_select",
              "aten::take"}


@dataclasses.dataclass
class RaceFinding:
    where: str          # algorithm / traceable name
    op: str             # the op's name, "aten::scatter_reduce_"
    scoped: bool
    detail: str


@dataclasses.dataclass
class RaceReport:
    name: str
    findings: list = dataclasses.field(default_factory=list)
    reads: int = 0          # unscoped gathers of chained state (evidence)
    commits: int = 0        # commit scopes that wrote (the healthy path)
    kernel_commits: int = 0  # scoped kernel ops (one per launch on a card)

    @property
    def ok(self) -> bool:
        return not self.findings


def _extends(rec) -> bool:
    return (rec.view or torch.Tag.pointwise in rec.tags
            or rec.name in ALIAS_OPS)


def walk(records, chain: set, rep: RaceReport) -> RaceReport:
    """Walk one round's records; ``chain`` holds the storage keys known
    to alias round state (grown in place)."""
    where = rep.name
    wrote = set()
    for rec in records:
        on = any(t.key in chain for t in rec.inputs)
        outs = {t.key for t in rec.outputs + rec.writes}
        if rec.name in KERNEL_OPS:
            if rec.scoped:
                rep.kernel_commits += 1
                wrote.add(rec.scope)
            elif on:
                rep.findings.append(RaceFinding(
                    where=where, op=rec.name, scoped=False,
                    detail=f"kernel launch ({rec.name}) writes round "
                           f"state outside commit()'s conflict resolution "
                           f"— a fused-kernel commit site must run under "
                           f"commit_scope() (reads of the same array this "
                           f"round: {rep.reads})"))
            if on:
                chain.update(outs)
            continue
        if is_scatter(rec.name):
            operand = rec.args[0] if rec.args else None
            chained = getattr(operand, "key", None) in chain
            if rec.scoped:
                wrote.add(rec.scope)
            elif chained:
                rep.findings.append(RaceFinding(
                    where=where, op=rec.name, scoped=False,
                    detail=f"raw {rec.name} into round state outside "
                           f"commit()'s conflict resolution — an in-wave "
                           f"write race (reads of the same array this "
                           f"round: {rep.reads})"))
            if chained:
                chain.update(outs)
            continue
        if rec.name in GATHER_OPS:
            if on and not rec.scoped:
                rep.reads += 1
            continue
        if on and _extends(rec):
            chain.update(outs)
    rep.commits = len(wrote)
    return rep


@contextlib.contextmanager
def _no_env_sanitize():
    """Record the SHIPPED program: the REPRO_SANITIZE shadow replay would
    otherwise add its own commits to the record (spec-level
    ``sanitize=True`` is still honored — that is part of the program
    under analysis)."""
    old = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_SANITIZE", None)
        else:
            os.environ["REPRO_SANITIZE"] = old


def _static(spec: CommitSpec | None) -> CommitSpec:
    spec = spec if spec is not None \
        else CommitSpec(backend="atomic", stats=False)
    if spec.backend == AUTO:
        raise ValueError("the race pass records static specs only: "
                         "backend='auto' would record its calibration")
    return spec


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def check_traceable(name: str, fn, *example_args) -> RaceReport:
    """Race-check one callable whose positional args are ALL round
    state (each tensor leaf seeds the chain)."""
    rep = RaceReport(name=name)
    rec = OpRecorder()
    chain = {rec.key(t) for t in _tensors(list(example_args))}
    with _no_env_sanitize(), rec:
        fn(*example_args)
    return walk(rec.records, chain, rep)


# -- single-shard WaveRuntime stand-in --------------------------------------

class LintRuntime:
    """Single-shard :class:`repro_torch.core.engine.WaveRuntime` mimic.

    ``wave`` commits on the same composite keys production uses (so the
    protected write path runs under ``commit_scope``); collectives are
    identities (one shard owns everything); telemetry attributes exist
    so round functions can read them."""

    def __init__(self, block: int, batch=None,
                 spec: CommitSpec | None = None, device="cpu"):
        self.block = int(block)
        self.batch = batch
        self.spec = _static(spec)
        self.device = torch.device(device)
        self.level = None
        self.max_subrounds = 1
        self.conflicts = torch.zeros((), dtype=torch.int32,
                                     device=self.device)
        self.subrounds = 0
        self.messages = torch.zeros((), dtype=torch.int32,
                                    device=self.device)
        self.delivered_all = True

    @property
    def shard(self) -> int:
        return 0

    @property
    def gid(self) -> torch.Tensor:
        return torch.arange(self.block, dtype=torch.int32,
                            device=self.device)

    def psum(self, x):
        return x

    def any(self, mask) -> torch.Tensor:
        return mask.any()

    def wave(self, state_l, target, payload, valid, *, op: str,
             major=None, batch=None):
        batch = batch if batch is not None else self.batch
        width = batch.wave_width if batch is not None else 1
        key = torch.as_tensor(target).to(torch.int32).clamp(0, self.block - 1)
        if width > 1:
            if major is None:
                raise ValueError("wave_width > 1 needs per-message "
                                 "`major` item ids")
            key = fuse_keys(key, torch.as_tensor(major).to(torch.int32)
                            .clamp(0, width - 1), width)
        valid = torch.as_tensor(valid).to(torch.bool)
        key = torch.where(valid, key, -1)
        s_leaves, tdef = tree_flatten(state_l)
        p_leaves, _ = tree_flatten(payload)
        if len(p_leaves) != len(s_leaves):
            raise ValueError("state/payload trees must match")
        new_s, succ = [], []
        for s, p in zip(s_leaves, p_leaves):
            res = commit(s, make_messages(key, p, valid), op, self.spec)
            new_s.append(res.state)
            succ.append(res.success)
        return tree_unflatten(tdef, new_s), tree_unflatten(tdef, succ)

    def gather(self, arr_l, idx, valid=None, *, fill=0):
        idxc = torch.as_tensor(idx).clamp(0, self.block - 1).long()
        if valid is None:
            valid = torch.ones(idxc.shape, dtype=torch.bool,
                               device=idxc.device)

        def read(a):
            return torch.where(valid, a[idxc], torch.as_tensor(
                fill, dtype=a.dtype, device=a.device))

        return tree_map(read, arr_l)


# -- entry-point catalog ----------------------------------------------------

def _tiny_graphs(seed: int = 0, device="cpu"):
    """One weighted tiny graph + a 2-graph GraphSet (sizes differ so
    graph-batch offsets are non-trivial)."""
    from repro_torch.graphs.csr import GraphSet
    from repro_torch.graphs.generators import erdos_renyi, random_weights
    g = random_weights(erdos_renyi(12, avg_degree=3.0, seed=seed,
                                   device=device), seed=1)
    gs = GraphSet([
        random_weights(erdos_renyi(7, avg_degree=3.0, seed=seed + 1,
                                   device=device), seed=2),
        random_weights(erdos_renyi(11, avg_degree=3.0, seed=seed + 2,
                                   device=device), seed=3),
    ])
    return g, gs


def entry_points(device="cuda"):
    """``(label, thunk)`` for every public distributed/batched wrapper —
    the thunk raises :class:`repro_torch.core.engine.LintCapture`."""
    from repro_torch.graphs.algorithms import (bfs, boruvka, coloring,
                                               pagerank, sssp, stconn)
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(device=device)
    g, gs = _tiny_graphs(device=mesh.device)
    L, G = 2, len(gs.graphs)
    dev = mesh.device
    srcL = torch.zeros((L,), dtype=torch.int32, device=dev)
    srcG = torch.zeros((G,), dtype=torch.int32, device=dev)
    srcLG = torch.zeros((L, G), dtype=torch.int32, device=dev)
    tG = torch.ones((G,), dtype=torch.int32, device=dev)
    return [
        ("bfs/distributed",
         lambda: bfs.distributed_bfs(mesh, g, 0)),
        ("bfs/lanes",
         lambda: bfs.distributed_multi_source_bfs(mesh, g, srcL)),
        ("bfs/product",
         lambda: bfs.distributed_product_bfs(mesh, gs, srcLG)),
        ("bfs/graphs",
         lambda: bfs.batched_over_graphs_bfs(gs, srcG, mesh=mesh)),
        ("sssp/distributed",
         lambda: sssp.distributed_sssp(mesh, g, 0)),
        ("sssp/lanes",
         lambda: sssp.distributed_multi_source_sssp(mesh, g, srcL)),
        ("sssp/graphs",
         lambda: sssp.batched_over_graphs_sssp(gs, srcG, mesh=mesh)),
        ("pagerank/distributed",
         lambda: pagerank.distributed_pagerank(mesh, g)),
        ("pagerank/lanes",
         lambda: pagerank.distributed_multi_source_pagerank(mesh, g,
                                                            srcL)),
        ("pagerank/graphs",
         lambda: pagerank.batched_over_graphs_pagerank(gs, srcG,
                                                       mesh=mesh)),
        ("coloring/distributed",
         lambda: coloring.distributed_coloring(mesh, g)),
        ("coloring/graphs",
         lambda: coloring.batched_over_graphs_coloring(gs, mesh=mesh)),
        ("stconn/distributed",
         lambda: stconn.distributed_stconn(mesh, g, 0, 1)),
        ("stconn/lanes",
         lambda: stconn.distributed_multi_source_stconn(mesh, g, srcG,
                                                        tG)),
        ("stconn/graphs",
         lambda: stconn.batched_over_graphs_stconn(gs, srcG, tG,
                                                   mesh=mesh)),
        ("boruvka/distributed",
         lambda: boruvka.distributed_boruvka(mesh, g)),
        ("boruvka/forest",
         lambda: boruvka.distributed_boruvka_forest(mesh, g)),
        ("boruvka/graphs",
         lambda: boruvka.batched_over_graphs_boruvka(gs, mesh=mesh)),
    ]


def capture_algorithms(points=None, device="cuda"):
    """Run every entry point under the capture seam; returns
    ``[(label, LintCapture)]``."""
    out = []
    points = entry_points(device) if points is None else points
    E._LINT_CAPTURE = True
    try:
        for label, thunk in points:
            try:
                thunk()
            except E.LintCapture as cap:
                # drop the traceback: its frames would keep the wrapper's
                # tensors alive in a reference cycle
                out.append((label, cap.with_traceback(None)))
                continue
            raise RuntimeError(
                f"{label}: run_distributed was never reached — entry "
                f"point changed shape; update the aamlint catalog")
    finally:
        E._LINT_CAPTURE = False
    return out


def _lint_edges(g) -> E.EdgeSlice:
    n = g.num_edges
    return E.EdgeSlice(
        src=g.src.to(torch.int32), dst=g.dst.to(torch.int32),
        weight=g.weights.to(torch.float32),
        valid=torch.ones((n,), dtype=torch.bool, device=g.device),
        eid=torch.arange(n, dtype=torch.int32, device=g.device),
        my_src=g.src.long())


def round_of(cap, spec: CommitSpec | None = None):
    """``(state0, step)``: a captured algorithm's initial state on its
    graph's device and its round 0 on :class:`LintRuntime` as a callable
    of the state alone."""
    g, batch = cap.g, cap.batch
    layout = E.ShardLayout(1, g.num_vertices, g.num_edges, g.num_vertices,
                           g.num_edges)
    state0, scalars0 = cap.alg.init(g, layout)
    edges = _lint_edges(g)
    # block = vertex range; wave() clamps targets to it and fuses the
    # major ids itself, so fused [block * width] state needs no special
    # casing here
    rt = LintRuntime(block=layout.block, batch=batch, spec=spec,
                     device=g.device)

    def step(state):
        return cap.alg.round_fn(rt, edges, state, scalars0, 0)

    return state0, step


def check_algorithm(label: str, cap, spec: CommitSpec | None = None
                    ) -> RaceReport:
    """Run one captured algorithm's round step under the recorder and
    race-check it."""
    state0, step = round_of(cap, spec)
    return check_traceable(f"{label} ({cap.alg.name})", step, state0)


def check_all(extra_traceables=(), *, spec: CommitSpec | None = None,
              device="cuda") -> list[RaceReport]:
    """Race-check every distributed entry point + the ProductWave chunk
    bodies (+ any ``(name, fn, example_state)`` extras, e.g. planted
    modules) on the ``spec`` tier (default ``atomic``) on ``device``."""
    spec = _static(spec)
    reports = [check_algorithm(label, cap, spec)
               for label, cap in capture_algorithms(device=device)]
    from repro_torch.serve.product_wave import lint_traceables
    for name, fn, example in lint_traceables(spec=spec, device=device):
        reports.append(check_traceable(name, fn, example))
    for name, fn, example in extra_traceables:
        reports.append(check_traceable(name, fn, example))
    return reports
