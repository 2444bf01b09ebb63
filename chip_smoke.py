#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # Kronecker scale 21, N = 2**26; no options

Phases, one or more lines each:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of the four CUDA kernels (one ``nvcc`` per source, in
   parallel);
3. each commit kernel against its plain version on the card, over op x
   dtype x stats x target skew x tile_m (the odd 7 and every transaction
   size of the tuner's ladder) at V = 2**21, N = 2**26 (state
   bit-identical, float ``add`` within rtol 2e-4 / atol 1e-6, conflicts
   equal), then each checked against and timed beside its plain version
   on the main path's own message batch (f32 ``add``, f32 and int32
   ``min``, int32 ``or`` and ``first``), and one ``scatter_reduce_`` call
   timed on it (none computes ``first``); the
   bucket-count kernel equal to its plain version
   over num_buckets x owner skew x masked share at N = 2**26 and at
   N = 0 and 1, then timed beside its plain version and
   ``torch.bincount`` on the engine's own batch (the owner ids of a
   scale-21 PageRank sub-round at world size 1) and on the ids an
   8-shard layout would count;
4. the single-shard path: ``bfs``, ``sssp`` and ``pagerank`` (20
   iterations) on a Graph500 Kronecker graph (scale 21, edge factor 16,
   seed 0) on each of the four commit backends, which must agree (ranks
   scaled by V within rtol 2e-4 / atol 1e-6, rank mass within 1e-5 of
   1);
5. ``bfs`` and ``pagerank`` on a scale-16 graph against the
   ``bfs_reference`` and float64 ``pagerank_reference`` oracles;
6. the wave engine at world size 1 on the phase-4 graph, on ``pallas``
   and ``fused``: ``distributed_bfs``, ``distributed_sssp`` and
   ``distributed_pagerank`` (20 iterations) at capacity 2**24 (so a
   PageRank iteration takes 4 sub-rounds), and
   ``distributed_multi_source_bfs`` with 4 lanes; distances equal phase
   4's bit for bit, each lane equals ``bfs`` from its source, ranks
   agree with phase 4's, every message is delivered;
8. the graph slice, after phase 6 on the same graph: (a) st-connectivity
   (from phase 4's source to a vertex at the largest BFS distance and to
   an unreached one), Boman coloring (seed 0, a valid coloring) and
   Boruvka (random weights, seed 0) on each of the four backends, equal
   bit for bit; (b) on phase 5's scale-16 graph, against ``st_reference``,
   ``validate_coloring`` and ``mst_reference`` (rtol 1e-5); (c) 4-lane
   ``multi_source_stconn`` and ``multi_source_pagerank`` (5 iterations)
   equal to the looped single queries; (d) 8 Kronecker scale-16 tenants
   (seeds 0-7): the six ``batched_over_graphs_*``, each member equal to
   its single-graph run, and the 4-lane ``distributed_product_bfs``; (e)
   the wave engine at world size 1, capacity 2**24: the distributed
   st-connectivity, coloring and Boruvka, 4-lane SSSP, PageRank and
   st-connectivity, and the ``mesh=`` route of the six
   ``batched_over_graphs_*``, each equal to (a), (c) or (d) with every
   message delivered; (c)-(e) on ``pallas`` and ``fused``;
9. the tuned, traced and sanitised commit, after phase 8 on the same
   graph: (a) ``CommitSpec(backend="auto")`` at ``stats=False`` and
   ``True`` on ``bfs``, ``sssp``, ``pagerank`` (20 iterations),
   ``coloring``, ``boruvka`` and ``st_connectivity``, each equal to phase
   4's or 8's static ``pallas`` output, timed beside it (the first call
   calibrates), the kernel tiers in every calibration, the tuner's audit
   printed; (b) a second ``AutoTuner`` on (a)'s cache file gives the same
   policies with no timed run; (c) auto ``distributed_bfs`` and
   ``distributed_pagerank`` at world size 1, C = 2**24, equal to phase 6's
   with every message delivered, ``m_final`` printed; (d) a degraded
   ``distributed_bfs`` (``snapshot_rounds=2``, one injected fault) equal
   to phase 6's; (e) ``run_transactions`` over 32,768 transactions of 6
   vertices in 2**16, every vertex visited, with retries; (f)
   ``trace=True`` on auto ``bfs`` and ``distributed_bfs`` (one record per
   commit or round, a valid trace) and ``sanitize=True`` on ``pallas``
   ``bfs`` and ``pagerank`` (no ``SanitizeError``), with their costs;
10. graph serving, after phase 9: ``GraphService(max_lanes=4,
   max_graphs=16)`` over phase 4's graph and phase 8d's tenants, a
   63-query stream (on the scale-21 graph 4 BFS, 4 SSSP, 4 PPR, 2
   st-connectivity; on each tenant a BFS, SSSP, PPR, st-connectivity,
   coloring and MST; a duplicate and a cache hit): (a) the synchronous
   product drain on ``atomic`` (the plain tier, no kernel launched),
   ``pallas`` and ``fused``, the kernel tiers equal to ``atomic`` and to
   each other, each launching its kernel, its ``ServiceStats`` and the
   device ms of each wave (CUDA events around the service's own
   ``wave`` trace spans); (b) the
   ``product=False`` drain, equal to (a), to phase 4 and to phase 8d;
   (c) ``ContinuousServer(round_chunk=4)`` fed by two threads in three
   bursts, every ticket answered once, at least one query boarding a
   running wave, p50/p99 submit-to-answer; (d) a ``ServiceSupervisor``
   fault at the second product wave, restore and WAL replay, the
   snapshot's bytes and seconds; (e) the ``mesh=`` route at world size
   1, C = 2**24; (f) an ``auto`` service snapshotted and restored onto
   a fresh tuner, which times nothing;
7. Mamba2-780m at its published width (48 layers, d_model 1536, 48 SSD
   heads of 64, state 128), bf16 compute over f32 weights drawn on the
   card from a seed: ``generate()`` on 8 x 2048 prompt tokens + 32 greedy
   tokens (the SSD kernel once per layer), the prefill and decode times;
   the SSD kernel against its plain version over chunk length x (N, P) x
   f32/bf16 with cumsum(a) falling to -250 over a chunk, then timed
   beside it on layer 0's own inputs, in f32 and cast to bf16; on-card
   oracles in f32: the kernel
   path's logits against the einsum path's, S - k prefill + k decode
   steps against an S prefill, and ``ssm_apply`` against the sequential
   ``ssm_ref``.

11. every decoder family's serving path, after phase 7: (a)
   phi3.5-moe-42b-a6.6b at its published width (d_model 4096, 32 heads
   of 128, 8 KV heads, 16 experts of 6400, top 2), 8 of its 32 layers,
   bf16 compute over f32 weights drawn on the card: ``generate()`` on 4 x
   2048 prompt tokens + 16 greedy tokens (the bucket-count kernel once
   per MoE layer per forward, ``moe_dropped`` 0), prefill and decode
   times, peak memory, the expert rows' padding share, and the
   bucket-count kernel against its plain version on layer 0's own owner
   ids, timed beside it and ``torch.bincount``; (b) qwen2-1.5b whole:
   ``generate()`` on 8 x 2048 + 32 tokens, prefill, decode, peak; (c)
   on-card oracles in f32, each printed beside its bound: phi3.5 layer 0
   at T = 512, ``moe_apply_aam`` against ``moe_apply_dense`` and the
   kernel-counted plan against ``torch.bincount``'s; phi3.5 S - 8
   prefill + 8 decode steps against an S prefill (2 x 256), both
   prefills with K/V rounded to bf16 as the cache stores them, every
   layer routing each token alike; gemma2-27b at its published width, 2
   layers (local, global) on 1 x 8192 tokens: the chunked attention path
   against the direct one, and an 8184 prefill + 8 decode steps
   (wrapping the local ring) against the 8192 prefill.
12. training, after phase 11: (a) phi3.5-moe-42b-a6.6b at its published
   width, 2 of its 32 layers (2,864,861,184 parameters: f32 weights,
   gradients and AdamW's m and v take 45.8 GB), bf16 compute,
   ``remat="full"``, AdamW at the reference's defaults, 6 steps of
   ``make_train_step`` on 4 x 2048 ``TokenStream(seed=0)`` tokens: ms a
   step (median of steps 2-6), tokens/s, peak memory, and each step's
   loss, grad norm, ``moe_dropped`` and ``moe_aux``, every loss and norm
   finite; the bucket-count kernel exactly twice per MoE layer per
   microbatch per step (forward and remat recompute); (b) qwen2-1.5b
   whole, 4 steps on 4 x 2048 at ``microbatches=2``; (c) f32 oracles at
   smoke width: 3 phi3.5 steps on the card against the CPU from the
   same weights (loss rtol 1e-5, parameters atol 1e-5; the first step's
   gradients at rtol 1e-4 / atol 1e-6, an update from the same
   gradients at 1e-6; whether a second card run repeats the first bit
   for bit is printed), every plan of the card's run equal to
   ``count_backend="jnp"``'s; a
   ``TrainSupervisor`` with a fault at step 6 against an uninterrupted
   run (one restart, atol 1e-5); ``launch.train.main`` twice on one
   checkpoint directory, the second resuming; smoke Mamba2 training on
   the plain SSD path, and ``use_pallas=True`` raising under autograd;
   (d) a one-rank NCCL group: ``moe_apply(impl="aam_shmap",
   mode="train")`` against ``"aam"``, and ``make_compressed_dp_step``
   against the dequantised single-rank mean.
13. the static analysis and the FLOP counter on the card, the four
   kernels as dispatched ops: (a) ``python -m repro_torch.analysis.lint
   --device cuda --trace-off-clean`` on each tier exits 0, every one of
   its 22 entries clean with a commit, and on the kernel tiers the
   scoped kernel commits equal the commit kernels' launches; (b) a
   planted module, written to a temporary directory, exits 1 with
   exactly the raw-scatter and unscoped-kernel findings; (c) one round
   of each of the six algorithms on phase 4's scale-21 graph on
   ``pallas`` and ``fused``, untraced and under the race pass (clean,
   each scoped kernel op a launch), beside phase 4's ms a round; (d)
   ``cost_of`` over phase 11a's phi3.5 prefill and phase 11b's qwen2
   prefill: FLOPs, dot FLOPs, bytes, the bucket-count ops (one a MoE
   layer, each a launch) and the expert rows' padding share; (e) smoke
   Mamba2's prefill counts the same dot FLOPs on the SSD kernel as on
   the plain path.  Parts c and d run where their data is, after phase 10
   and inside phase 11; a, b and e after phase 12.
14. the parallel layouts and the dry run, after phase 13: (a)
   ``make_sharded_train_step`` on a one-rank NCCL group
   (``make_host_mesh(1, 1)``: the tensor-parallel step on a model axis of
   one), phi3.5-moe at its published width, phase 12a's 2 layers, f32,
   remat full, 2 AdamW steps on 4 x 2048, parameters and AdamW state as
   DTensors, against ``make_train_step`` from the same seed (run in turn;
   parameters within 1e-6), ms a step and peak memory of both; (b)
   ``pipeline_forward`` on 2 gloo ranks both on ``cuda:0`` (spawned;
   boundary tensors through host memory), phi3.5-moe at its published
   width, 2 stages of 1 block, 2 microbatches of 1 x 2048, f32: the
   logits against each microbatch's plain forward (1e-5) and the
   gradients of a cross entropy against the plain forward's (1e-4), each
   stage's ms, the bytes crossing the boundary, peak memory; (c) the dry
   run (``python -m repro_torch.launch.dryrun``, one process a cell,
   started in the background after phase 2 and read after phase
   15: qwen2-1.5b x train_4k, prefill_32k, decode_32k on 16 x 16 and
   phi3.5-moe x train_4k on 2 x 16 x 16, fake tensors, a ``fake`` process
   group) and the roofline rows, host seconds and collective totals;
15. tensor-parallel compute over ``"model"``, after phase 14, on two
   gloo ranks sharing ``cuda:0`` as a ``(data 1, model 2)`` mesh
   (spawned; collectives through host memory): (a) phase 14a's phi3.5
   step computed on each rank's shards (16 of 32 heads, 8 of 16 experts,
   half the vocab; the router read whole), 2 AdamW steps, against 14a's
   unsharded run (losses and gradient norms within rtol 1e-5, every
   parameter within 1e-5), the step's all-gathers only routers, the
   count kernel's launches on each rank; (b) mamba2-780m whole, f32, a
   prefill of 2 x 2048 with the SSD kernel on each rank's 24 of 48 heads,
   logits and SSM states within 1e-4 of the largest against the
   one-process prefill; (c) the dry run's train_4k cells of qwen2-1.5b,
   mamba2-780m, phi3.5-moe and jamba on 16 x 16, priced on the
   tensor-parallel step (collective and compute seconds a device);
16. the sequence over ``"model"``, after phase 15, on two gloo ranks
   sharing ``cuda:0`` as a ``(data 1, model 2)`` mesh: (a) phase 15a's
   phi3.5 step with ``seq_parallel=True`` (each rank 1,024 of the 2,048
   positions between layers, attention on them with every head; the
   MLP, experts and vocab on their shards over the gathered sequence),
   batch 0's gradients against the unsharded ones (rtol 1e-4 / atol 1e-6,
   every element), the first update against AdamW on its own gradients,
   2 steps, ms a step, GiB a rank, the count kernel's launches; (b)
   mamba2-780m whole, f32, a sequence-parallel prefill of 2 x 2048 (the
   SSD kernel on each rank's 24 heads over the gathered sequence),
   logits within 1e-4 of the largest against the one-process prefill;
   (c) qwen2-1.5b whole, bf16, a tensor-parallel prefill of 2 x 2048 and
   16 greedy tokens decoded on a cache split on ``cache_seq`` (1,032 of
   2,064 slots a rank), the tokens against the one-process
   ``generate()``'s, decode ms a token, cache GiB a rank; (d) the dry
   run's four train_4k cells with ``--seq-parallel`` beside 15c's, and
   14c's qwen2 decode_32k cell, which reads its cache in place.
17. the examples and the wave engine across ranks, after phase 16: (a)
   the five scripts of ``examples_torch/`` (quickstart, graph_analytics
   ``--distributed``, distributed_pagerank, serve_queries, train_lm's
   300 steps of lm-100m and a second run resuming from step 300), each a
   subprocess on the card in its own directory under
   ``chiprun_out/phase17a``, the five at once, each exiting 0 on its own
   asserts (the two distributed scripts spawn 8 gloo ranks on the card);
   (b) ``run_distributed`` at world size 8: 8 spawned gloo ranks sharing
   ``cuda:0`` (collectives through host memory; the kernels built in the
   parent) run ``distributed_bfs`` (C = auto and C = 2**14, where
   sub-rounds exceed rounds), ``distributed_sssp`` and
   ``distributed_pagerank`` (20 iterations) on ``fused`` on phase 4's
   scale-21 graph (saved with phase 4's answers after phase 13c), equal
   to phase 4's bit for bit (ranks within rtol 2e-4 / atol 1e-6), and
   ``distributed_bfs``, ``distributed_stconn`` (to a reached and an
   unreached vertex), ``distributed_coloring`` and
   ``distributed_boruvka`` on ``pallas`` on the scale-16 tenant (phase 5's
   graph, phase 8d's tenant 0), equal to the single-shard runs, every
   message delivered; ms a round beside phase 6's, sub-rounds, each
   rank's peak GiB; (c) ``distributed_bfs`` and ``distributed_boruvka``
   there with ``snapshot_rounds=2`` and a fault before chunk 1 on every
   rank: the mesh shrinks 8 -> 7 and the answers equal (b)'s.

Phases 4, 6, 8, 9, 10, 7, 11, 12, 13, 14, 15, 16 and 17 (run in that
order) are the main path: each zeroes the kernels' launch counters
before it (each part of phase 13 before it) and reads them after, and fails if a kernel
of its path was not launched (phase 6: the
bucket count, and the fused kernel with 4 lanes; phases 8 and 10: both
commit kernels and the bucket count; phase 9: a commit kernel and the
bucket count; phase 7: the SSD kernel once per layer; phase 11: the
bucket count once per MoE layer per forward of its ``generate()``; phase
12a: the bucket count exactly as remat implies; phase 13: all four;
phase 14: the bucket count as remat implies, in the sharded steps and in
each pipeline stage, whose counters its processes report; phase 15: the
bucket count as remat implies on each rank's steps, the SSD kernel once
per layer on each rank's prefill; phase 16: the same on the
sequence-parallel step and prefill; phase 17: both commit kernels and
the bucket count on the ranks of (b) and (c), whose counters they
report; the examples of (a) run in subprocesses of their own and are
not counted).
Every wrapper launches its kernel through a dispatched op
(``torch.ops.repro_torch.*``), so the call ms below include the op's
dispatch.  Then one
JSON
line of per-kernel numbers (``ms``, ``plain_ms`` and ``library_ms`` are
device ms per launch, from launches back to back; ``call_ms`` is one
launch after a synchronise, what a caller pays per call) and, last, the
line
``{"ok": true, "device": {...}}``.  Any failed check raises, and
the script exits non-zero without that line.  It needs one card and the
checkout's ``src/``; it imports nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the H100 SXM's published peaks, kept in one place
from repro_torch.launch.roofline import F32_FLOPS as F32_FLOP_PER_S  # noqa: E402
from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.roofline import PEAK_FLOPS as BF16_FLOP_PER_S  # noqa: E402
ADD_RTOL, ADD_ATOL = 2e-4, 1e-6
SCALE = 21                         # Kronecker scale of the main path's graph
GRID_LOG2_V, GRID_LOG2_N = 21, 26  # phase 3's state and batch sizes
REPS = 10                          # one-launch timings per kernel (call ms)
SEED = 0
OPS = ("min", "max", "add", "or", "first")
KERNELS = {   # name -> (source in the repo, the TPU kernel it replaces)
    "coarse_commit": ("src/repro_torch/kernels/csrc/coarse_commit.cu",
                      "src/repro/kernels/coarse_commit.py:52"),
    "fused_route_commit": ("src/repro_torch/kernels/csrc/fused_wave.cu",
                           "src/repro/kernels/fused_wave.py:55"),
    "bucket_count": ("src/repro_torch/kernels/csrc/coalesce.cu",
                     "src/repro/kernels/coalesce.py:18"),
    "ssd_chunk": ("src/repro_torch/kernels/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd_chunk.py:19"),
}
COUNT_BUCKETS = (1, 7, 8, 128, 1000, 65536)   # phase 3's bucket-count grid
TILE_MS = (7, 16, 64, 256, 1024, 4096)  # phase 3: the odd 7 and the ladder
TXN_SHAPE = (32768, 6, 1 << 16)    # phase 9e: transactions, vertices each,
#                                    V; (32,768)^2 keys stay below 2^31
ENGINE_CAPACITY = 2 ** 24          # phases 6 and 8's coalescing factor C
LANES = 4                          # phases 6 and 8's query lanes
LANE_PPR_ITERS = 5                 # phase 8's lane PageRank iterations
TENANTS = (8, 16)                  # phase 8's graph batch: count, scale
SERVE_GRAPHS = 16                  # phase 10's graph budget of a wave
MAMBA = "mamba2-780m"              # phase 7's model, at its published width
PROMPT, NEW_TOKENS = (8, 2048), 32  # phase 7's batch x prompt, greedy tokens
SSD_LS = (1, 7, 64, 100, 125, 128)  # phase 7's chunk lengths
SSD_NPS = ((16, 16), (128, 64))    # (state N, head dim P): smoke, published
ORACLE = (2, 1024)                 # phase 7's f32 oracles: batch x tokens
PHI = "phi3.5-moe-42b-a6.6b"       # phase 11a's model, at its published width
PHI_LAYERS = 8                     # of 32: the whole model is 84 GB in bf16
PHI_PROMPT, PHI_NEW = (4, 2048), 16  # phase 11a: batch x prompt, greedy
PHI_ORACLE_T = 512                 # phase 11c: layer 0's MoE, tokens
LM_ORACLE = (2, 256)               # phase 11c: phi3.5 decode vs prefill
QWEN = "qwen2-1.5b"                # phase 11b's model, whole
QWEN_PROMPT, QWEN_NEW = (8, 2048), 32
GEMMA = "gemma2-27b"               # phase 11c: a local and a global layer
GEMMA_SEQ = 8192
DECODE_K = 8                       # phase 11c: decode steps after S - k
PHI_TRAIN_LAYERS = 2               # phase 12a: of 32; f32 weights, grads
#                                    and AdamW's m, v take 45.8 GB
TRAIN_BATCH = (4, 2048)            # phase 12a and b: batch x sequence
PHI_TRAIN_STEPS, QWEN_TRAIN_STEPS = 6, 4
ORACLE_TRAIN = (8, 64)             # phase 12c: smoke-width batch x sequence
# phase 12c: the CPU tests' bounds (loss, gradients, an update from the
# same gradients, parameters after several steps and after a resume)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
UPDATE_ATOL, PARAM_ATOL = 1e-6, 1e-5


def say(*parts):
    print(*parts, flush=True)


def call_ms(fn, reps: int = REPS) -> float:
    """Call ms: the median over ``reps`` of one call of ``fn`` bracketed
    by an event pair after a synchronise, after one warm-up call.  The
    card waits while the host prepares the launch, so this is what a
    caller pays per call;
    ``repro_torch.obs.timing.device_ms`` gives the card's time
    per launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed(fn):
    """``fn()`` and its host seconds from a synchronised start to a
    synchronised end."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def wall_s(fn) -> float:
    """Host seconds of ``fn``, as :func:`timed` takes them."""
    return timed(fn)[1]


def kron_targets(n: int, log2_v: int, gen, device):
    """Targets with the Graph500 Kronecker in-degree skew (each id bit is
    1 with probability b + d = 0.24), relabelled by a permutation."""
    import torch
    key = torch.zeros(n, dtype=torch.int64, device=device)
    for _ in range(log2_v):
        bit = torch.rand(n, generator=gen, device=device) < 0.24
        key = key * 2 + bit.long()
    perm = torch.randperm(1 << log2_v, generator=gen, device=device)
    return perm[key]


def grid_inputs(op, dtype, v, n, gen, device):
    """(state, val) with each op's contract: 'first' = non-negative
    payloads into partly empty (< 0) state, 'or' = truth values.  Float
    payloads are multiples of 1/8, so sums stay exact in any order."""
    import torch
    def ints(lo, hi, k):
        return torch.randint(lo, hi, (k,), generator=gen, device=device)
    if op == "first":
        state = torch.where(torch.rand(v, generator=gen, device=device)
                            < 0.5, -1, ints(0, 50, v))
        val = ints(0, 50, n)
    elif op == "or":
        state, val = ints(0, 2, v), ints(0, 2, n)
    else:
        state, val = ints(-50, 50, v), ints(-50, 50, n)
        if dtype == torch.float32:
            val = val / 8.0
    return state.to(dtype), val.to(dtype)


def compare(name, op, got, exp, stats) -> float:
    """Raise unless the kernel's result equals the plain version's;
    returns the state's max abs difference."""
    import torch
    if stats:
        (got, got_c), (exp, exp_c) = got, exp
        if int(got_c) != int(exp_c):
            raise AssertionError(f"{name}: conflicts {int(got_c)} != plain "
                                 f"{int(exp_c)}")
    if op == "add" and got.dtype == torch.float32:
        torch.testing.assert_close(got, exp, rtol=ADD_RTOL, atol=ADD_ATOL,
                                   msg=lambda m: f"{name}: {m}")
        return float((got - exp).abs().max())
    if not torch.equal(got, exp):
        bad = int((got != exp).sum())
        raise AssertionError(f"{name}: {bad} state entries differ")
    return 0.0


def phase_kernel_grid(device, max_err):
    """Phase 3: both kernels against their plain versions."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.coarse_commit import coarse_commit_kernel
    from repro_torch.kernels.fused_wave import fused_route_commit_kernel
    v, n = 1 << GRID_LOG2_V, 1 << GRID_LOG2_N
    gen = torch.Generator(device=device).manual_seed(SEED)
    targets = {"uniform": torch.randint(0, v, (n,), generator=gen,
                                        device=device),
               "kronecker": kron_targets(n, GRID_LOG2_V, gen, device)}
    width, base = 4, v // 2                      # fused layout with lanes
    t0, cases = time.perf_counter(), 0
    for skew, tgt in targets.items():
        drop = torch.rand(n, generator=gen, device=device)
        idx = torch.where(drop < 0.1, -1, tgt)
        idx = torch.where(drop > 0.99, v + (tgt % 64), idx)   # past V
        idx = idx.to(torch.int32).contiguous()
        lane = torch.where(drop < 0.98, idx % width, width).to(torch.int32)
        g_tgt = torch.where(idx >= 0, base + idx // width, -1).to(
            torch.int32)
        for op in OPS:
            for dtype in (torch.int32, torch.float32):
                state, val = grid_inputs(op, dtype, v, n, gen, device)
                for stats in (False, True):
                    for tile_m in TILE_MS:
                        runs = [
                            ("coarse_commit", coarse_commit_kernel,
                             ref.coarse_commit_ref, (state, idx, val),
                             dict(block_v=512)),
                            ("fused_route_commit", fused_route_commit_kernel,
                             ref.fused_route_commit_ref, (state, idx, val),
                             {})]
                        if tile_m == 256:
                            runs.append((
                                "fused_route_commit",
                                fused_route_commit_kernel,
                                ref.fused_route_commit_ref,
                                (state, g_tgt, val),
                                dict(lane=lane, base=base, width=width)))
                        for name, kernel, plain, kargs, kw in runs:
                            kw = dict(kw, op=op, tile_m=tile_m, stats=stats)
                            got = kernel(*kargs, **kw)
                            exp = plain(*kargs, **kw)
                            torch.cuda.synchronize()
                            label = (f"{name}/{op}/{str(dtype)[6:]}/{skew}/"
                                     f"tile_m={tile_m}/stats={stats}"
                                     f"{'/lanes' if 'lane' in kw else ''}")
                            err = compare(label, op, got, exp, stats)
                            max_err[name] = max(max_err[name], err)
                            cases += 1
    say(f"phase 3: {cases} kernel-vs-plain cases agree at V=2^"
        f"{GRID_LOG2_V}, N=2^{GRID_LOG2_N} "
        f"({time.perf_counter() - t0:.1f} s); max |err| "
        + ", ".join(f"{k}={e:.3g}" for k, e in max_err.items()))


def phase_kernel_times(g, device, max_err):
    """Each kernel checked against and timed beside its plain version on
    the main path's batch (every edge a message, as in a PageRank
    iteration), and one ``scatter_reduce_`` call.  Returns {kernel:
    numbers} for f32 add."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.coarse_commit import coarse_commit_kernel
    from repro_torch.kernels.fused_wave import fused_route_commit_kernel
    from repro_torch.obs.timing import device_ms
    v, n = g.num_vertices, g.num_edges
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    idx = g.dst
    bound_ms = (8 * n + 8 * v) / HBM_BYTES_PER_S * 1e3
    library_index = idx.long()
    out = {}
    say(f"phase 3: the main path's batch (N={n}, V={v}), each kernel "
        f"equal to its plain version, then device ms (20 launches back to "
        f"back between two events, median of 3 windows) of the kernel, its "
        f"plain version and scatter_reduce_, and the kernel's call ms "
        f"(one launch after a synchronise, median of {REPS}); bound = "
        f"(8N + 8V) bytes / 3.35 TB/s = {bound_ms:.4f} ms")
    # `or` on 0/1 payloads is scatter_reduce_'s "amax"; no one PyTorch call
    # computes `first` with its lowest-index tie-break
    for op, dtype, reduce in (("add", torch.float32, "sum"),
                              ("min", torch.float32, "amin"),
                              ("min", torch.int32, "amin"),
                              ("or", torch.int32, "amax"),
                              ("first", torch.int32, None)):
        state, val = grid_inputs(op, dtype, v, n, gen, device)
        buf = state.clone()
        library = None if reduce is None else device_ms(
            lambda: buf.scatter_reduce_(0, library_index, val, reduce))
        for name, kernel, plain_fn in (
                ("coarse_commit", coarse_commit_kernel,
                 ref.coarse_commit_ref),
                ("fused_route_commit", fused_route_commit_kernel,
                 ref.fused_route_commit_ref)):
            label = f"{name}/{op}/{str(dtype)[6:]}/main-path batch"
            for stats in (False, True):
                err = compare(f"{label}/stats={stats}", op,
                              kernel(state, idx, val, op=op, stats=stats),
                              plain_fn(state, idx, val, op=op, stats=stats),
                              stats)
                max_err[name] = max(max_err[name], err)
            plain = device_ms(lambda: plain_fn(state, idx, val, op=op))
            ms = device_ms(lambda: kernel(state, idx, val, op=op))
            call = call_ms(lambda: kernel(state, idx, val, op=op))
            lib = ("scatter_reduce_ (none computes first)" if library is None
                   else f"scatter_reduce_ {library:.4f} ms")
            say(f"  {name:19s} {op}/{str(dtype)[6:]:8s} kernel device "
                f"{ms:.4f} ms, call {call:.4f} ms  plain {plain:.4f} ms  "
                f"{lib}  bound {bound_ms:.4f} ms")
            if (op, dtype) == ("add", torch.float32):
                out[name] = dict(ms=ms, call_ms=call, plain_ms=plain,
                                 library_ms=library, bound_ms=bound_ms,
                                 bound_by="bytes")
                stats_ms = device_ms(lambda: kernel(state, idx, val, op=op,
                                                    stats=True))
                say(f"  {name:19s} {op}/{str(dtype)[6:]:8s} kernel with "
                    f"stats=True (tile_m=256) device {stats_ms:.4f} ms")
    return out


def phase_main_path(g, device):
    """Phase 4: BFS, SSSP and PageRank on every backend.  Returns the
    kernels' launch counts of this phase, the ``pallas`` backend's
    (bfs result, sssp dist, pagerank ranks) and each backend's ms a round
    (a PageRank iteration)."""
    import torch
    from repro_torch.core.commit import BACKENDS, CommitSpec
    from repro_torch.graphs.algorithms.bfs import bfs
    from repro_torch.graphs.algorithms.pagerank import pagerank
    from repro_torch.graphs.algorithms.sssp import sssp
    from repro_torch.graphs.generators import random_weights
    from repro_torch.kernels.coarse_commit import coarse_commit_kernel
    from repro_torch.kernels.fused_wave import fused_route_commit_kernel
    src = int(torch.argmax(g.degrees))
    gw = random_weights(g, seed=0)
    results, round_ms = {}, {}
    coarse_commit_kernel.launches = 0
    fused_route_commit_kernel.launches = 0
    for backend in BACKENDS:
        spec = CommitSpec(backend=backend, m=None, stats=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rb = bfs(g, src, spec=spec)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sd, srounds = sssp(gw, src, spec=spec)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pr, _ = pagerank(g, iters=20, spec=spec)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        results[backend] = (rb, sd, srounds, pr)
        round_ms[backend] = {"bfs": (t1 - t0) / rb.rounds * 1e3,
                             "sssp": (t2 - t1) / srounds * 1e3,
                             "pagerank": (t3 - t2) / 20 * 1e3}
        say(f"phase 4: {backend:6s} bfs {rb.rounds} rounds "
            f"{(t1 - t0) / rb.rounds * 1e3:.2f} ms/round, "
            f"{int(rb.messages)} messages; sssp {srounds} rounds "
            f"{(t2 - t1) / srounds * 1e3:.2f} ms/round; pagerank "
            f"{(t3 - t2) / 20 * 1e3:.2f} ms/iter; peak {peak:.2f} GiB")
    launches = {"coarse_commit": coarse_commit_kernel.launches,
                "fused_route_commit": fused_route_commit_kernel.launches}
    # Ranks average 1/V, so they are compared scaled by V: the absolute
    # tolerance then sits far below every rank, not above most of them.
    v = g.num_vertices
    rb0, sd0, sr0, pr0 = results["atomic"]
    pr_err = 0.0
    for backend, (rb, sd, sr, pr) in results.items():
        if not torch.equal(rb.dist, rb0.dist):
            raise AssertionError(f"bfs dist differs on {backend}")
        if (rb.rounds, int(rb.messages)) != (rb0.rounds, int(rb0.messages)):
            raise AssertionError(f"bfs rounds/messages differ on {backend}")
        if not torch.equal(sd, sd0) or sr != sr0:
            raise AssertionError(f"sssp dist/rounds differ on {backend}")
        torch.testing.assert_close(pr * v, pr0 * v, rtol=ADD_RTOL,
                                   atol=ADD_ATOL,
                                   msg=lambda m: f"pagerank x V, {backend}: "
                                                 f"{m}")
        pr_err = max(pr_err, float(((pr - pr0).abs() / pr0.abs()).max()))
    reached = int((rb0.dist < 2 ** 30).sum())
    mass = float(pr0.double().sum())
    if not (torch.isfinite(pr0).all() and abs(mass - 1) < 1e-5
            and reached > 1):
        raise AssertionError(f"main path output is not sane (pagerank mass "
                             f"{mass!r}, bfs reached {reached})")
    say(f"phase 4: all four backends agree (bfs reached {reached} of {v}; "
        f"pagerank mass {mass:.9f}, largest relative difference from "
        f"atomic {pr_err:.3g}); launches {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    rb, sd, _, pr = results["pallas"]
    return launches, (rb, sd, pr), round_ms


def count_ids(n, nb, skew, masked, gen, device):
    """Owner ids for the bucket-count grid: ``skew`` uniform, Kronecker
    in-degree (a Kronecker vertex id // ceil(2**21 / nb), as the router
    computes owners) or one bucket; a ``masked`` share of the ids
    replaced, half by -1 and half by ids >= nb."""
    import torch
    if skew == "uniform":
        ids = torch.randint(0, nb, (n,), generator=gen, device=device)
    elif skew == "kronecker":
        block = -(-(1 << GRID_LOG2_V) // nb)
        ids = kron_targets(n, GRID_LOG2_V, gen, device) // block
    else:
        ids = torch.full((n,), nb // 2, device=device)
    drop = torch.rand(n, generator=gen, device=device) < masked
    high = nb + torch.randint(0, 1000, (n,), generator=gen, device=device)
    half = torch.rand(n, generator=gen, device=device) < 0.5
    ids = torch.where(drop, torch.where(half, -1, high), ids)
    return ids.to(torch.int32).contiguous()


def phase_count_grid(device, max_err):
    """Phase 3: the bucket-count kernel equal to its plain version."""
    import torch
    from repro_torch.kernels.coalesce import bucket_count_kernel
    from repro_torch.kernels.ref import bucket_count_ref
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    t0, cases = time.perf_counter(), 0

    def check(label, owner, nb):
        got = bucket_count_kernel(owner, nb)
        exp = bucket_count_ref(owner, nb)
        torch.cuda.synchronize()
        err = float((got.long() - exp.long()).abs().max())
        max_err["bucket_count"] = max(max_err["bucket_count"], err)
        if not torch.equal(got, exp):
            raise AssertionError(f"bucket_count/{label}: counts differ "
                                 f"(max |err| {err})")
    for nb in COUNT_BUCKETS:
        for skew in ("uniform", "kronecker", "one-bucket"):
            for masked in (0.0, 0.5, 1.0):
                owner = count_ids(1 << GRID_LOG2_N, nb, skew, masked, gen,
                                  device)
                check(f"nb={nb}/{skew}/masked={masked}", owner, nb)
                cases += 1
        for n in (0, 1):
            check(f"nb={nb}/N={n}", count_ids(n, nb, "uniform", 0.0, gen,
                                               device), nb)
            cases += 1
    say(f"phase 3: {cases} bucket-count cases equal their plain version "
        f"at N=2^{GRID_LOG2_N} (and N=0, 1), num_buckets in "
        f"{COUNT_BUCKETS} ({time.perf_counter() - t0:.1f} s); max |err| "
        f"bucket_count={max_err['bucket_count']:.3g}")


def synchronises(fn) -> bool:
    """Whether ``fn`` makes the host wait for the card
    (``torch.cuda.set_sync_debug_mode``)."""
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return any("synchroniz" in str(w.message) for w in caught)


def phase_count_times(g, device):
    """Phase 3: the bucket-count kernel timed beside its plain version and
    ``torch.bincount`` on the owner ids the engine counts.  Returns the
    numbers of the engine's own batch."""
    import torch
    from repro_torch.kernels.coalesce import bucket_count_kernel
    from repro_torch.kernels.ref import bucket_count_ref
    from repro_torch.obs.timing import device_ms
    v, n = g.num_vertices, g.num_edges
    out = None
    for shards, label in ((1, "the engine's own batch: the owner ids of a "
                              "PageRank sub-round at world size 1"),
                          (8, "not a run of the engine: the owner ids an "
                              "8-shard layout of the same graph would "
                              "count (dst // block)")):
        block = -(-v // shards)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        owner_c = torch.where(valid, g.dst // block, shards).to(torch.int32)
        masked = torch.where(valid, owner_c, -1).to(torch.int32)
        got = bucket_count_kernel(masked, shards)
        if not torch.equal(got, bucket_count_ref(masked, shards)):
            raise AssertionError(f"bucket_count differs on {label}")
        ms = device_ms(lambda: bucket_count_kernel(masked, shards))
        call = call_ms(lambda: bucket_count_kernel(masked, shards))
        plain = device_ms(lambda: bucket_count_ref(masked, shards))
        library = device_ms(lambda: torch.bincount(
            owner_c, minlength=shards + 1)[:shards])
        bound = (4 * n + 4 * shards) / HBM_BYTES_PER_S * 1e3
        say(f"phase 3: bucket_count on {label}: N={n}, {shards} bucket(s): "
            f"kernel device {ms:.4f} ms, call {call:.4f} ms  plain "
            f"{plain:.4f} ms  torch.bincount {library:.4f} ms (it makes the "
            f"host wait for the card, so its device ms hold that wait)  "
            f"bound (4N + 4B) bytes / 3.35 TB/s = {bound:.4f} ms")
        if out is None:
            out = dict(ms=ms, call_ms=call, plain_ms=plain,
                       library_ms=library, bound_ms=bound, bound_by="bytes")
            sync_lib = synchronises(lambda: torch.bincount(
                owner_c, minlength=shards + 1))
            sync_kernel = synchronises(
                lambda: bucket_count_kernel(masked, shards))
            say(f"phase 3: the host waits for the card in torch.bincount: "
                f"{sync_lib}; in the bucket-count kernel: {sync_kernel}")
    return out


def phase_engine(g, device, single):
    """Phase 6: the wave engine at world size 1 on ``pallas`` and
    ``fused``, held to phase 4's single-shard results.  Returns the
    kernels' launch counts of this phase and, by backend and algorithm,
    its (ms a round, sub-rounds a round), which phase 17b prints beside
    its own."""
    import numpy as np
    import torch
    from repro_torch.core.commit import CommitSpec
    from repro_torch.graphs.algorithms.bfs import (
        bfs, distributed_bfs, distributed_multi_source_bfs)
    from repro_torch.graphs.algorithms.pagerank import distributed_pagerank
    from repro_torch.graphs.algorithms.sssp import distributed_sssp
    from repro_torch.graphs.generators import random_weights
    from repro_torch.kernels.coalesce import bucket_count_kernel
    from repro_torch.kernels.coarse_commit import coarse_commit_kernel
    from repro_torch.kernels.fused_wave import fused_route_commit_kernel
    from repro_torch.launch.mesh import make_mesh
    kernels = {"coarse_commit": coarse_commit_kernel,
               "fused_route_commit": fused_route_commit_kernel,
               "bucket_count": bucket_count_kernel}
    bfs0, sssp0, ranks0 = single
    v = g.num_vertices
    src = int(torch.argmax(g.degrees))
    rng = np.random.default_rng(SEED)
    others = rng.choice(np.flatnonzero(g.degrees.cpu().numpy() > 0),
                        LANES - 1, replace=False)
    sources = [src] + [int(x) for x in others]
    gw = random_weights(g, seed=0)
    lane_ref = [bfs0.dist] + [
        bfs(g, s, spec=CommitSpec(backend="pallas", stats=False)).dist
        for s in sources[1:]]
    mesh = make_mesh(device=device)
    launches = {name: 0 for name in kernels}
    lane_fused = 0
    figures = {}
    for backend in ("pallas", "fused"):
        kw = dict(capacity=ENGINE_CAPACITY, telemetry=True,
                  spec=CommitSpec(backend=backend, stats=False))
        runs = {
            "bfs": lambda: distributed_bfs(mesh, g, src, **kw),
            "sssp": lambda: distributed_sssp(mesh, gw, src, **kw),
            "pagerank": lambda: distributed_pagerank(mesh, g, iters=20,
                                                     **kw),
            f"multi_bfs L={LANES}": lambda: distributed_multi_source_bfs(
                mesh, g, sources, **kw)}
        # the set-up every call repeats before its first round: the edge
        # partition on the host, the edge slice to the card, the state
        setup = wall_s(lambda: distributed_pagerank(mesh, g, iters=0, **kw))
        say(f"phase 6: {backend:6s} set-up of a call (a 0-iteration "
            f"distributed_pagerank): {setup * 1e3:.1f} ms; ms/round below "
            f"= (call - set-up) / rounds")
        for k in kernels.values():
            k.launches = 0
        for name, run in runs.items():
            before = fused_route_commit_kernel.launches
            torch.cuda.reset_peak_memory_stats()
            result = []
            wall = wall_s(lambda: result.extend(run()))
            *out, res = result
            if name.startswith("multi_bfs"):
                lane_fused += fused_route_commit_kernel.launches - before
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            figures.setdefault(backend, {})[name] = (
                (wall - setup) / res.rounds * 1e3,
                res.subrounds / res.rounds)
            say(f"phase 6: {backend:6s} {name:14s} {res.rounds} rounds, "
                f"{(wall - setup) / res.rounds * 1e3:.2f} ms/round "
                f"(call {wall * 1e3:.1f} ms), "
                f"{res.subrounds / res.rounds:.2f} sub-rounds/round, "
                f"peak {peak:.2f} GiB, delivered_all={res.delivered_all}")
            if not res.delivered_all:
                raise AssertionError(f"phase 6 {backend} {name}: messages "
                                     f"left undelivered")
            got = out[0]
            if name == "bfs" and not torch.equal(got, bfs0.dist):
                raise AssertionError(f"distributed_bfs ({backend}) != bfs")
            if name == "sssp" and not torch.equal(got, sssp0):
                raise AssertionError(f"distributed_sssp ({backend}) != sssp")
            if name == "pagerank":
                torch.testing.assert_close(
                    got * v, ranks0 * v, rtol=ADD_RTOL, atol=ADD_ATOL,
                    msg=lambda m: f"distributed_pagerank ({backend}): {m}")
            if name.startswith("multi_bfs"):
                for lane, exp in enumerate(lane_ref):
                    if not torch.equal(got[lane], exp):
                        raise AssertionError(
                            f"distributed_multi_source_bfs ({backend}) lane "
                            f"{lane} != bfs from {sources[lane]}")
        for k_name, k in kernels.items():
            launches[k_name] += k.launches
    say(f"phase 6: the engine equals phase 4 on pallas and fused (sources "
        f"{sources}); launches {launches}, of which fused_route_commit "
        f"with width {LANES}: {lane_fused}")
    for name in ("bucket_count", "coarse_commit", "fused_route_commit"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the engine "
                                 f"path")
    if lane_fused < 1:
        raise AssertionError(f"fused_route_commit was not launched with "
                             f"width {LANES}")
    return launches, figures


def graph_kernels():
    """The three graph kernels' wrappers, by name."""
    from repro_torch.kernels.coalesce import bucket_count_kernel
    from repro_torch.kernels.coarse_commit import coarse_commit_kernel
    from repro_torch.kernels.fused_wave import fused_route_commit_kernel
    return {"coarse_commit": coarse_commit_kernel,
            "fused_route_commit": fused_route_commit_kernel,
            "bucket_count": bucket_count_kernel}


def launches_since(before=None):
    """The graph kernels' launch counters, less ``before`` (an earlier
    reading) where given: what ran in between, with the counters left
    running."""
    now = {name: k.launches for name, k in graph_kernels().items()}
    return {name: n - (before or {}).get(name, 0) for name, n in now.items()}


def count_launches(fn):
    """``fn()`` and the launches of the three graph kernels in it, the
    counters set to 0 first."""
    for k in graph_kernels().values():
        k.launches = 0
    out = fn()
    return out, launches_since()


def far_and_lone(dist):
    """(a vertex at the largest finite BFS distance, the first vertex the
    BFS did not reach, or -1 when it reached every vertex)."""
    import torch
    reached = dist < 2 ** 29
    far = int(torch.argmax(torch.where(reached, dist, -1)))
    lone = torch.nonzero(~reached)
    return far, int(lone[0]) if len(lone) else -1


def equal(what, got, exp):
    """Raise unless two results (tensors, numbers, or tuples of them) are
    equal bit for bit."""
    import torch
    if isinstance(exp, (tuple, list)):
        if len(got) != len(exp):
            raise AssertionError(f"{what}: {len(got)} outputs != {len(exp)}")
        for i, (a, b) in enumerate(zip(got, exp)):
            equal(f"{what}[{i}]", a, b)
    elif isinstance(exp, torch.Tensor):
        if not torch.equal(got.to(exp.device), exp):
            raise AssertionError(f"{what}: differs")
    elif got != exp:
        raise AssertionError(f"{what}: {got!r} != {exp!r}")


def close_ranks(what, got, exp, v):
    """PageRank ranks scaled by V within rtol 2e-4 / atol 1e-6."""
    import torch
    torch.testing.assert_close(got * v, exp * v, rtol=ADD_RTOL,
                               atol=ADD_ATOL, msg=lambda m: f"{what}: {m}")


def phase8_single(g, gw, dist0):
    """Phase 8a: st-connectivity, coloring and Boruvka on scale 21 on each
    backend, equal across backends.  Returns the endpoints and the
    ``pallas`` results."""
    import torch
    from repro_torch.core.commit import BACKENDS, CommitSpec
    from repro_torch.graphs.algorithms.boruvka import boruvka
    from repro_torch.graphs.algorithms.coloring import (coloring,
                                                        validate_coloring)
    from repro_torch.graphs.algorithms.stconn import st_connectivity
    src = int(torch.argmax(g.degrees))
    far, lone = far_and_lone(dist0)
    if lone < 0:
        raise AssertionError("the scale-21 BFS reached every vertex")
    results = {}
    for backend in BACKENDS:
        spec = CommitSpec(backend=backend, stats=False)
        torch.cuda.reset_peak_memory_stats()
        (ff, rf), tf = timed(lambda: st_connectivity(g, src, far, spec=spec))
        (fl, rl), tl = timed(lambda: st_connectivity(g, src, lone,
                                                     spec=spec))
        (color, rc, nc), tc = timed(lambda: coloring(g, seed=0, spec=spec))
        (comp, w, ne, rb), tb = timed(lambda: boruvka(gw, spec=spec))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        results[backend] = ((bool(ff), rf, bool(fl), rl), (color, rc,
                                                            bool(nc)),
                            (comp, w, int(ne), rb))
        say(f"phase 8a: {backend:6s} st_connectivity found={bool(ff)} in "
            f"{rf} rounds {tf / rf * 1e3:.2f} ms/round, unreached target "
            f"found={bool(fl)} in {rl} rounds {tl / rl * 1e3:.2f} ms/round; "
            f"coloring {rc} rounds {tc / rc * 1e3:.2f} ms/round, "
            f"{int(color.max()) + 1} colors; boruvka {rb} rounds "
            f"{tb / rb * 1e3:.2f} ms/round, weight {float(w):.6f}, "
            f"{int(ne)} edges; peak {peak:.2f} GiB")
    base = results["atomic"]
    for backend, res in results.items():
        equal(f"phase 8a {backend} vs atomic", res, base)
    (ff, _, fl, _), (color, _, nc), (comp, w, ne, _) = base
    if not ff or fl:
        raise AssertionError(f"st_connectivity: found {ff} for a reached "
                             f"target, {fl} for an unreached one")
    if nc or not validate_coloring(g, color):
        raise AssertionError("coloring did not converge to a valid coloring")
    if not (0 < ne < g.num_vertices and torch.isfinite(w)):
        raise AssertionError(f"boruvka: {ne} edges, weight {float(w)}")
    say(f"phase 8a: all four backends agree bit for bit (source {src}, "
        f"reached target {far}, unreached {lone}); the coloring is valid")
    return src, far, lone, results["pallas"]


def phase8_oracles(small):
    """Phase 8b: on scale 16 (phase 5's graph), st-connectivity against
    ``st_reference``, coloring against ``validate_coloring`` and the MST
    weight against ``mst_reference`` within rtol 1e-5."""
    import torch
    from repro_torch.core.commit import CommitSpec
    from repro_torch.graphs.algorithms.bfs import bfs
    from repro_torch.graphs.algorithms.boruvka import boruvka, mst_reference
    from repro_torch.graphs.algorithms.coloring import (coloring,
                                                        validate_coloring)
    from repro_torch.graphs.algorithms.stconn import (st_connectivity,
                                                      st_reference)
    from repro_torch.graphs.generators import random_weights
    src = int(torch.argmax(small.degrees))
    far, lone = far_and_lone(bfs(small, src, spec=CommitSpec(
        backend="pallas", stats=False)).dist)
    ref = {t: st_reference(small, src, t) for t in (far, lone)}
    sw = random_weights(small, seed=0)
    mst = mst_reference(sw)
    for backend in ("pallas", "fused"):
        spec = CommitSpec(backend=backend, stats=False)
        for t, exp in ref.items():
            found, _ = st_connectivity(small, src, t, spec=spec)
            if bool(found) != exp:
                raise AssertionError(f"st_connectivity({backend}) to {t} != "
                                     f"st_reference")
        color, _, nc = coloring(small, seed=0, spec=spec)
        if nc or not validate_coloring(small, color):
            raise AssertionError(f"coloring({backend}) is not valid")
        _, w, _, _ = boruvka(sw, spec=spec)
        if abs(float(w) - mst) > 1e-5 * mst:
            raise AssertionError(f"boruvka({backend}) weight {float(w)} != "
                                 f"mst_reference {mst}")
    say(f"phase 8b: on scale 16 (pallas, fused), st_connectivity equals "
        f"st_reference ({ref}), the colorings are valid, the MST weight "
        f"is within rtol 1e-5 of mst_reference ({mst:.6f})")


def phase8_lanes(g, ss, ts):
    """Phase 8c: 4-lane ``multi_source_stconn`` and
    ``multi_source_pagerank`` on scale 21 equal the looped single-query
    runs.  Returns the ``pallas`` results."""
    import torch
    from repro_torch.core.commit import CommitSpec
    from repro_torch.graphs.algorithms.pagerank import (
        multi_source_pagerank, personalized_pagerank)
    from repro_torch.graphs.algorithms.stconn import (multi_source_stconn,
                                                      st_connectivity)
    v = g.num_vertices
    out = {}
    for backend in ("pallas", "fused"):
        spec = CommitSpec(backend=backend, stats=False)
        torch.cuda.reset_peak_memory_stats()
        (found, rounds), t_st = timed(lambda: multi_source_stconn(
            g, ss, ts, spec=spec))
        (rank, _), t_pr = timed(lambda: multi_source_pagerank(
            g, ss, iters=LANE_PPR_ITERS, spec=spec))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        loop = [bool(st_connectivity(g, s, t, spec=spec)[0])
                for s, t in zip(ss, ts)]
        if found.tolist() != loop:
            raise AssertionError(f"multi_source_stconn ({backend}) "
                                 f"{found.tolist()} != looped {loop}")
        for lane, s in enumerate(ss):
            one, _ = personalized_pagerank(g, s, iters=LANE_PPR_ITERS,
                                           spec=spec)
            close_ranks(f"multi_source_pagerank ({backend}) lane {lane}",
                        rank[lane], one, v)
        say(f"phase 8c: {backend:6s} multi_source_stconn L={len(ss)} "
            f"found {found.tolist()} in {rounds} rounds "
            f"{t_st / rounds * 1e3:.2f} ms/round; multi_source_pagerank "
            f"L={len(ss)} {LANE_PPR_ITERS} iterations "
            f"{t_pr / LANE_PPR_ITERS * 1e3:.2f} ms/iter; peak {peak:.2f} GiB;"
            f" each lane equals its single-query run")
        out[backend] = (found, rank)
    return out["pallas"]


def phase8_batch(device):
    """Phase 8d: 8 Kronecker scale-16 tenants; the six
    ``batched_over_graphs_*`` on ``pallas`` and ``fused``, each member
    equal to its single-graph run, and the 4-lane
    ``distributed_product_bfs`` on the set.  Returns (set, weighted set,
    sources, targets, the ``pallas`` batched results)."""
    import numpy as np
    import torch
    from repro_torch.core.commit import CommitSpec
    from repro_torch.graphs.algorithms import (bfs, boruvka, coloring,
                                               pagerank, sssp, stconn)
    from repro_torch.graphs.csr import GraphSet
    from repro_torch.graphs.generators import kronecker, random_weights
    from repro_torch.launch.mesh import make_mesh
    count, scale = TENANTS
    t0 = time.perf_counter()
    members = [kronecker(scale, 16, seed=i, device=device)
               for i in range(count)]
    wmembers = [random_weights(m, seed=i) for i, m in enumerate(members)]
    gs, gws = GraphSet(members), GraphSet(wmembers)
    say(f"phase 8d: {count} Kronecker scale-{scale} tenants (seeds 0-"
        f"{count - 1}): V={gs.num_vertices} E={gs.num_edges} in the union, "
        f"built on the host in {time.perf_counter() - t0:.1f} s")
    srcs = [int(torch.argmax(m.degrees)) for m in members]
    tgts = []
    for i, m in enumerate(members):     # even tenants reachable, odd not
        far, lone = far_and_lone(bfs.bfs(m, srcs[i]).dist)
        tgts.append(far if i % 2 == 0 or lone < 0 else lone)
    rng = np.random.default_rng(SEED + 8)
    lanes = [srcs] + [[int(rng.integers(0, m.num_vertices)) for m in members]
                      for _ in range(LANES - 1)]
    mesh = make_mesh(device=device)
    out = {}
    for backend in ("pallas", "fused"):
        spec = CommitSpec(backend=backend, stats=False)
        runs = {
            "bfs": lambda: bfs.batched_over_graphs_bfs(gs, srcs, spec=spec),
            "sssp": lambda: sssp.batched_over_graphs_sssp(gws, srcs,
                                                          spec=spec),
            "pagerank": lambda: pagerank.batched_over_graphs_pagerank(
                gs, srcs, spec=spec),
            "stconn": lambda: stconn.batched_over_graphs_stconn(
                gs, srcs, tgts, spec=spec),
            "coloring": lambda: coloring.batched_over_graphs_coloring(
                gs, spec=spec),
            "boruvka": lambda: boruvka.batched_over_graphs_boruvka(
                gws, spec=spec),
        }
        res, times = {}, {}
        for name, run in runs.items():
            res[name], times[name] = timed(run)
        ones = {"bfs": [bfs.bfs(m, s, spec=spec).dist
                        for m, s in zip(members, srcs)],
                "sssp": [sssp.sssp(m, s, spec=spec)[0]
                         for m, s in zip(wmembers, srcs)],
                "stconn": torch.stack([stconn.st_connectivity(
                    m, s, t, spec=spec)[0] for m, s, t in
                    zip(members, srcs, tgts)]),
                "coloring": [coloring.coloring(m, spec=spec)[0]
                             for m in members],
                "boruvka": [boruvka.boruvka(m, spec=spec)[:3]
                            for m in wmembers]}
        equal(f"batched bfs ({backend})", res["bfs"], ones["bfs"])
        equal(f"batched sssp ({backend})", res["sssp"], ones["sssp"])
        for i, (m, s) in enumerate(zip(members, srcs)):
            close_ranks(f"batched pagerank ({backend}) tenant {i}",
                        res["pagerank"][i], pagerank.personalized_pagerank(
                            m, s, spec=spec)[0], m.num_vertices)
        equal(f"batched stconn ({backend})", res["stconn"], ones["stconn"])
        colors, _, nc = res["coloring"]
        equal(f"batched coloring ({backend})", colors, ones["coloring"])
        if nc.any():
            raise AssertionError(f"batched coloring ({backend}) did not "
                                 f"converge")
        equal(f"batched boruvka ({backend})", res["boruvka"][0],
              ones["boruvka"])
        torch.cuda.reset_peak_memory_stats()
        (dist, rounds, tel), t_pb = timed(lambda: bfs.distributed_product_bfs(
            mesh, gs, lanes, capacity=ENGINE_CAPACITY, spec=spec,
            telemetry=True))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not tel.delivered_all:
            raise AssertionError(f"distributed_product_bfs ({backend}): "
                                 f"messages left undelivered")
        for lane, row in enumerate(lanes):
            equal(f"distributed_product_bfs ({backend}) lane {lane}",
                  gs.split_vertex(dist[lane]),
                  bfs.batched_over_graphs_bfs(gs, row, spec=spec))
        say(f"phase 8d: {backend:6s} batched_over_graphs_* over "
            f"{count} tenants, call ms: "
            + ", ".join(f"{k} {t * 1e3:.1f}" for k, t in times.items())
            + f"; stconn found {res['stconn'].tolist()}; coloring "
            f"{res['coloring'][1]} rounds, boruvka {res['boruvka'][1]} "
            f"rounds; each member equals its single-graph run; "
            f"distributed_product_bfs L={LANES} x G={count} {rounds} rounds "
            f"{t_pb * 1e3:.1f} ms, {tel.subrounds / rounds:.2f} "
            f"sub-rounds/round, peak {peak:.2f} GiB, each lane equals "
            f"batched_over_graphs_bfs")
        out[backend] = res
    return gs, gws, srcs, tgts, out["pallas"]


def phase8_engine(g, gw, device, single, lanes, batch):
    """Phase 8e: the wave engine at world size 1, C = 2**24, on ``pallas``
    and ``fused``: the distributed st-connectivity, coloring and Boruvka,
    the 4-lane SSSP, PageRank and st-connectivity on scale 21, and the
    ``mesh=`` route of the six ``batched_over_graphs_*`` on the tenant
    set, each equal to phase 8a, 8c or 8d."""
    import torch
    from repro_torch.core.commit import CommitSpec
    from repro_torch.graphs.algorithms import (boruvka, coloring, pagerank,
                                               sssp, stconn)
    from repro_torch.graphs.algorithms import bfs
    from repro_torch.launch.mesh import make_mesh
    src, far, lone, (st, col, mst) = single
    ss, ts, (lane_found, lane_rank) = lanes
    gs, gws, srcs, tgts, gb = batch
    v = g.num_vertices
    lane_sssp = [sssp.sssp(gw, s, spec=CommitSpec(backend="pallas",
                                                  stats=False))[0]
                 for s in ss]
    mesh = make_mesh(device=device)
    for backend in ("pallas", "fused"):
        spec = CommitSpec(backend=backend, stats=False)
        kw = dict(capacity=ENGINE_CAPACITY, spec=spec, telemetry=True)
        runs = {
            "stconn reached": lambda: stconn.distributed_stconn(
                mesh, g, src, far, **kw),
            "stconn unreached": lambda: stconn.distributed_stconn(
                mesh, g, src, lone, **kw),
            "coloring": lambda: coloring.distributed_coloring(mesh, g, **kw),
            "boruvka": lambda: boruvka.distributed_boruvka(mesh, gw, **kw),
            f"multi_sssp L={len(ss)}": lambda: (
                sssp.distributed_multi_source_sssp(mesh, gw, ss, **kw)),
            f"multi_ppr L={len(ss)}": lambda: (
                pagerank.distributed_multi_source_pagerank(
                    mesh, g, ss, iters=LANE_PPR_ITERS, **kw)),
            f"multi_stconn L={len(ss)}": lambda: (
                stconn.distributed_multi_source_stconn(mesh, g, ss, ts,
                                                       **kw)),
        }
        exp = {"stconn reached": (st[0],), "stconn unreached": (st[2],),
               "coloring": col, "boruvka": mst,
               f"multi_sssp L={len(ss)}": (torch.stack(lane_sssp),),
               f"multi_stconn L={len(ss)}": (lane_found,)}
        for name, run in runs.items():
            torch.cuda.reset_peak_memory_stats()
            (*out, res), wall = timed(run)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            say(f"phase 8e: {backend:6s} {name:18s} {res.rounds} rounds, "
                f"call {wall * 1e3:.1f} ms, {wall / res.rounds * 1e3:.2f} "
                f"ms/round, {res.subrounds / res.rounds:.2f} sub-rounds/"
                f"round, {wall / max(res.subrounds, 1) * 1e3:.2f} ms/"
                f"sub-round, peak {peak:.2f} GiB, "
                f"delivered_all={res.delivered_all}")
            if not res.delivered_all:
                raise AssertionError(f"phase 8e {backend} {name}: messages "
                                     f"left undelivered")
            if name.startswith("multi_ppr"):
                close_ranks(f"distributed_multi_source_pagerank ({backend})",
                            out[0], lane_rank, v)
            elif name.startswith("stconn"):
                equal(f"distributed_stconn ({backend}) {name}",
                      (bool(out[0]),), exp[name])
            elif name == "coloring":
                equal(f"distributed_coloring ({backend})",
                      (out[0], out[1], bool(out[2])), exp[name])
            elif name == "boruvka":
                equal(f"distributed_boruvka ({backend})",
                      (out[0], out[1], int(out[2]), out[3]), exp[name])
            else:
                equal(f"{name} ({backend})", (out[0],), exp[name])
        mkw = dict(mesh=mesh, capacity=ENGINE_CAPACITY, spec=spec)
        routes = {
            "bfs": lambda: bfs.batched_over_graphs_bfs(gs, srcs, **mkw),
            "sssp": lambda: sssp.batched_over_graphs_sssp(gws, srcs, **mkw),
            "pagerank": lambda: pagerank.batched_over_graphs_pagerank(
                gs, srcs, **mkw),
            "stconn": lambda: stconn.batched_over_graphs_stconn(
                gs, srcs, tgts, **mkw),
            "coloring": lambda: coloring.batched_over_graphs_coloring(
                gs, **mkw),
            "boruvka": lambda: boruvka.batched_over_graphs_boruvka(
                gws, **mkw),
        }
        times = {}
        for name, run in routes.items():
            got, times[name] = timed(run)
            if name == "pagerank":
                for i, (a, b) in enumerate(zip(got, gb[name])):
                    close_ranks(f"mesh route pagerank ({backend}) {i}", a, b,
                                gs.vsizes[i])
            else:
                equal(f"mesh route {name} ({backend})", got, gb[name])
        say(f"phase 8e: {backend:6s} the mesh= route of the six "
            f"batched_over_graphs_* equals phase 8d; call ms: "
            + ", ".join(f"{k} {t * 1e3:.1f}" for k, t in times.items()))


def phase_graph_slice(g, small, device, single):
    """Phase 8: the slice's main path (st-connectivity, coloring, Boruvka,
    the graph batch, the lane and engine forms).  Returns the three graph
    kernels' launches in it, phase 8a's endpoints and ``pallas`` results,
    and phase 8d's tenants with their ``pallas`` results."""
    import numpy as np
    import torch
    from repro_torch.graphs.generators import random_weights
    t0 = time.perf_counter()

    def run():
        bfs0 = single[0]
        gw = random_weights(g, seed=0)
        one = phase8_single(g, gw, bfs0.dist)
        phase8_oracles(small)
        src, far, lone, _ = one
        rng = np.random.default_rng(SEED + 8)
        others = rng.choice(np.flatnonzero(g.degrees.cpu().numpy() > 0),
                            LANES - 1, replace=False)
        ss = [src] + [int(x) for x in others]
        ts = [far, lone, ss[2], int(rng.integers(0, g.num_vertices))]
        lanes = (ss, ts, phase8_lanes(g, ss, ts))
        batch = phase8_batch(device)
        phase8_engine(g, gw, device, one, lanes, batch)
        return one, batch
    (one, batch), launches = count_launches(run)
    torch.cuda.synchronize()
    say(f"phase 8: done in {time.perf_counter() - t0:.1f} s; launches "
        f"{launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched in phase 8")
    return launches, one, batch


def _drop_at_chunk_1(chunk, rounds_done):
    """Phase 9d's fault: a simulated host drop before chunk 1."""
    if chunk == 1:
        raise RuntimeError("simulated host drop")


def phase_tuned(g, device, single, slice_one):
    """Phase 9: the tuned, traced and sanitised commit on phase 4's graph,
    held to phases 4, 6 and 8's static results.  Returns the three graph
    kernels' launches in it."""
    import os
    import tempfile
    import torch
    from repro_torch.core import autotune as AT
    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    cache_dir = tempfile.TemporaryDirectory(dir=ROOT / "build")
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(cache_dir.name,
                                                      "autotune.json")
    # every policy the run asks for, to ask a second tuner the same; and
    # the feedback steps of adaptive policies (each one host read), with
    # the transaction size each step leaves
    policies, steps = [], []
    real_policy_for, real_next_level = AT.policy_for, AT.next_level

    def policy_for(spec, state, msgs=None, **kw):
        pol = real_policy_for(spec, state, msgs, **kw)
        policies.append((spec, state, msgs, kw, pol))
        return pol

    def next_level(policy, *args):
        level = real_next_level(policy, *args)
        if policy.adaptive:               # a static policy reads nothing
            steps.append(policy.ladder[level] or 0)
        return level
    # seconds the default tuner spends calibrating and racing
    tuner, spent = AT.DEFAULT_TUNER, [0.0]

    def clocked(fn):
        def run(*args, **kw):
            out, sec = timed(lambda: fn(*args, **kw))
            spent[0] += sec
            return out
        return run
    AT.policy_for, AT.next_level = policy_for, next_level
    tuner.calibrate, tuner.race = clocked(tuner.calibrate), clocked(tuner.race)
    try:
        _, launches = count_launches(lambda: _phase9(
            g, device, single, slice_one, policies, steps, spent,
            real_policy_for))
    finally:
        AT.policy_for, AT.next_level = real_policy_for, real_next_level
        del tuner.calibrate, tuner.race
        os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
        cache_dir.cleanup()
    torch.cuda.synchronize()
    say(f"phase 9: done in {time.perf_counter() - t_phase:.1f} s; launches "
        f"{launches}")
    if (launches["coarse_commit"] + launches["fused_route_commit"] < 1
            or launches["bucket_count"] < 1):
        raise AssertionError("phase 9 launched no commit kernel or no "
                             "bucket count")
    return launches


def _phase9(g, device, single, slice_one, policies, steps, spent,
            real_policy_for):
    import numpy as np
    import torch
    from repro_torch.core import autotune as AT
    from repro_torch.core.commit import CommitSpec
    from repro_torch.core.ownership import run_transactions
    from repro_torch.graphs.algorithms.bfs import bfs, distributed_bfs
    from repro_torch.graphs.algorithms.boruvka import boruvka
    from repro_torch.graphs.algorithms.coloring import coloring
    from repro_torch.graphs.algorithms.pagerank import (distributed_pagerank,
                                                        pagerank)
    from repro_torch.graphs.algorithms.sssp import sssp
    from repro_torch.graphs.algorithms.stconn import st_connectivity
    from repro_torch.graphs.generators import random_weights
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs import Tracer, validate_trace, wavetap
    bfs0, sssp0, ranks0 = single
    src, far, _, (st, col, mst) = slice_one
    gw = random_weights(g, seed=0)
    v = g.num_vertices
    pallas = CommitSpec(backend="pallas", stats=False)
    # (a) the six algorithms at stats=False and True: static pallas, then
    # auto (a first call, which calibrates, and a warm call)
    algs = {
        "bfs": (lambda s: bfs(g, src, spec=s), lambda r: r.rounds,
                lambda r: equal("auto bfs", r.dist, bfs0.dist)),
        "sssp": (lambda s: sssp(gw, src, spec=s), lambda r: r[1],
                 lambda r: equal("auto sssp", r[0], sssp0)),
        "pagerank": (lambda s: pagerank(g, iters=20, spec=s),
                     lambda r: 20,
                     lambda r: close_ranks("auto pagerank", r[0], ranks0,
                                           v)),
        "coloring": (lambda s: coloring(g, seed=0, spec=s),
                     lambda r: r[1],
                     lambda r: equal("auto coloring",
                                     (r[0], r[1], bool(r[2])), col)),
        "boruvka": (lambda s: boruvka(gw, spec=s), lambda r: r[3],
                    lambda r: equal("auto boruvka",
                                    (r[0], r[1], int(r[2]), r[3]), mst)),
        "st_connectivity": (lambda s: st_connectivity(g, src, far, spec=s),
                            lambda r: r[1],
                            lambda r: equal("auto st_connectivity",
                                            (bool(r[0]),), (st[0],))),
    }
    warm = {}
    for name, (run, rounds_of, check) in algs.items():
        for stats in (False, True):
            static = CommitSpec(backend="pallas", stats=stats)
            out, t_static = timed(lambda: run(static))
            check(out)
            rounds = rounds_of(out)
            spec = CommitSpec(backend="auto", stats=stats)
            n_pol, cal = len(policies), spent[0]
            out, t_first = timed(lambda: run(spec))
            check(out)
            cal, n_steps = spent[0] - cal, len(steps)
            out, t_warm = timed(lambda: run(spec))
            check(out)
            pol = policies[-1][-1]
            warm[name, stats] = t_warm
            say(f"phase 9a: {name} stats={stats}, {rounds} rounds: static "
                f"pallas {t_static / rounds * 1e3:.2f} ms/round, auto "
                f"{t_warm / rounds * 1e3:.2f} (first call "
                f"{t_first * 1e3:.1f} ms, of which calibration and races "
                f"{cal * 1e3:.1f} ms); policy {pol.backend} "
                f"M0={pol.ladder[pol.init_level]} adaptive={pol.adaptive}; "
                f"{len(steps) - n_steps} feedback reads a call, M after "
                f"each: {steps[n_steps:][:24]}")
    tuner = AT.DEFAULT_TUNER
    excluded = [e for e in tuner.audit
                if e["event"] == "kernel_tiers_excluded"]
    cals = [e for e in tuner.audit if e["event"] == "calibrate"]
    if excluded or not cals or any(
            not {"pallas", "fused"} <= set(e["tiers"]) for e in cals):
        raise AssertionError(f"phase 9a: the kernel tiers were not all in "
                             f"the candidate set: {excluded or cals}")
    say(f"phase 9a: every auto run equals phase 4's or 8's static pallas "
        f"output; calibration and races {spent[0]:.1f} s in all; the "
        f"tuner's audit ({len(tuner.audit)} events, {tuner.timed_runs} "
        f"timed runs; the kernel tiers in every calibration):")
    for e in tuner.audit:
        say("  audit " + json.dumps(e, sort_keys=True))
    # (b) a second tuner on the same cache file times nothing
    second = AT.AutoTuner()
    for spec, state, msgs, kw, pol in policies:
        again = real_policy_for(spec, state, msgs, tuner=second, **kw)
        if again != pol:
            raise AssertionError(f"phase 9b: {again} != {pol}")
    if second.timed_runs:
        raise AssertionError(f"phase 9b: the warm tuner timed "
                             f"{second.timed_runs} runs")
    say(f"phase 9b: a second AutoTuner on the cache file: {len(policies)} "
        f"policies equal, timed_runs == 0")
    # (c) the engine at world size 1 under auto
    mesh = make_mesh(device=device)
    kw = dict(capacity=ENGINE_CAPACITY, telemetry=True)
    eng = {"distributed_bfs": (
               lambda s, **k: distributed_bfs(mesh, g, src, spec=s, **kw,
                                              **k),
               lambda out: equal("auto distributed_bfs", out[0],
                                 bfs0.dist)),
           "distributed_pagerank": (
               lambda s, **k: distributed_pagerank(mesh, g, iters=20,
                                                   spec=s, **kw, **k),
               lambda out: close_ranks("auto distributed_pagerank", out[0],
                                       ranks0, v))}
    clean = {}
    for name, (run, check) in eng.items():
        line = []
        for label, spec in (("static pallas", pallas),
                            ("auto, first call",
                             CommitSpec(backend="auto", stats=False)),
                            ("auto", CommitSpec(backend="auto",
                                                stats=False))):
            n_steps = len(steps)
            out, wall = timed(lambda: run(spec))
            res = out[-1]
            check(out)
            if not res.delivered_all:
                raise AssertionError(f"phase 9c {name} ({label}): messages "
                                     f"left undelivered")
            clean.setdefault(name, {})[label] = wall
            line.append(f"{label} {wall * 1e3:.1f} ms ({res.rounds} rounds, "
                        f"{res.subrounds} sub-rounds, m_final "
                        f"{res.m_final}, {len(steps) - n_steps} feedback "
                        f"reads)")
        say(f"phase 9c: {name} at C = 2^24, equal to phase 6's, every "
            f"message delivered: " + "; ".join(line))
    # (d) degraded mode: one injected fault, the chunk retried in place
    run, check = eng["distributed_bfs"]
    out, wall = timed(lambda: run(pallas, snapshot_rounds=2,
                                  fault_injector=_drop_at_chunk_1))
    check(out)
    if not out[-1].degraded:
        raise AssertionError("phase 9d: the run does not report degraded")
    say(f"phase 9d: degraded distributed_bfs (snapshot_rounds=2, a fault "
        f"before chunk 1) equals phase 6's: {wall * 1e3:.1f} ms against "
        f"{clean['distributed_bfs']['static pallas'] * 1e3:.1f} ms clean, "
        f"{out[-1].rounds} "
        f"rounds, degraded={out[-1].degraded}")
    # (e) the ownership protocol
    x, k, nv = TXN_SHAPE
    txns = np.random.default_rng(SEED).integers(0, nv, (1, x, k)).astype(
        np.int32)
    (visited, stats), wall = timed(lambda: run_transactions(
        mesh, torch.from_numpy(txns).to(device), nv, capacity=1 << 18))
    want = np.zeros(nv, bool)
    want[txns.reshape(-1)] = True
    if not (np.array_equal(visited.cpu().numpy(), want)
            and stats.retries > 0):
        raise AssertionError(f"phase 9e: run_transactions: visited differs "
                             f"or no retries ({stats})")
    say(f"phase 9e: run_transactions X={x}, K={k}, V={nv}: visited equals "
        f"the transactions' vertices; {stats.rounds} rounds, "
        f"{stats.retries} retries, {stats.bids} bids, {wall * 1e3:.1f} ms "
        f"({wall / stats.rounds * 1e3:.2f} ms/round)")
    # (f) the taps and the sanitizer
    wavetap.clear()
    r, wall = timed(lambda: bfs(g, src, spec=CommitSpec(
        backend="auto", stats=False, trace=True)))
    equal("traced auto bfs", r.dist, bfs0.dist)
    commits = wavetap.records()
    (*out, res), dwall = timed(lambda: distributed_bfs(
        mesh, g, src, spec=CommitSpec(backend="auto", stats=False,
                                      trace=True), **kw))
    equal("traced distributed_bfs", out[0], bfs0.dist)
    rounds_recs = wavetap.records()[len(commits):]
    tracer = Tracer(enabled=True)
    flushed = wavetap.flush_to(tracer)
    findings = validate_trace(tracer.to_chrome())
    if (len(commits) != r.rounds or len(rounds_recs) != res.rounds
            or flushed != r.rounds + res.rounds or findings):
        raise AssertionError(f"phase 9f: {len(commits)} commit records for "
                             f"{r.rounds} rounds, {len(rounds_recs)} round "
                             f"records for {res.rounds}; {findings}")
    say(f"phase 9f: trace=True: auto bfs {len(commits)} commit records, "
        f"{wall / r.rounds * 1e3:.2f} ms/round against "
        f"{warm['bfs', False] / r.rounds * 1e3:.2f} untraced; "
        f"distributed_bfs {len(rounds_recs)} round records, "
        f"{dwall * 1e3:.1f} ms against "
        f"{clean['distributed_bfs']['auto'] * 1e3:.1f} ms untraced; "
        f"validate_trace: no findings")
    for name in ("bfs", "pagerank"):
        run, rounds_of, check = algs[name]
        out, t_plain = timed(lambda: run(pallas))
        out, t_san = timed(lambda: run(CommitSpec(backend="pallas",
                                                  stats=False,
                                                  sanitize=True)))
        check(out)
        rounds = rounds_of(out)
        say(f"phase 9f: sanitize=True on pallas {name}: no SanitizeError; "
            f"{t_san / rounds * 1e3:.2f} ms/round against "
            f"{t_plain / rounds * 1e3:.2f}")


def serving_bursts(Q, hot_srcs, hot_pairs, srcs, tgts):
    """Phase 10's stream, three bursts of ``(graph id, query)``: on
    ``"hot"`` 4 BFS, 4 SSSP, 4 PPR and 2 st-connectivity queries; on each
    tenant a BFS, an SSSP, a PPR and an st-connectivity query from phase
    8d's endpoints, coloring (seed 0) and MST.  The first burst holds one
    duplicate, which the service dedups."""
    it = LANE_PPR_ITERS

    def hot(lo, hi):
        return ([("hot", Q.BfsQuery(s)) for s in hot_srcs[lo:hi]]
                + [("hot", Q.SsspQuery(s)) for s in hot_srcs[lo:hi]]
                + [("hot", Q.PprQuery(s, iters=it)) for s in hot_srcs[lo:hi]])

    def tenants(make):
        return [(f"t{i}", q) for i in range(len(srcs)) for q in make(i)]
    first = (hot(0, 2) + [("hot", Q.BfsQuery(hot_srcs[0]))]
             + [("hot", Q.StConnQuery(*hot_pairs[0]))]
             + tenants(lambda i: (Q.BfsQuery(srcs[i]), Q.SsspQuery(srcs[i]),
                                  Q.ColoringQuery(seed=0))))
    second = (hot(2, 4) + [("hot", Q.StConnQuery(*hot_pairs[1]))]
              + tenants(lambda i: (Q.PprQuery(srcs[i], iters=it),
                                   Q.StConnQuery(srcs[i], tgts[i]))))
    third = tenants(lambda i: (Q.MstQuery(),))
    return first, second, third


def same_row(what, got, exp):
    """Raise unless two service answers agree: bools, integer and ``min``
    rows bit for bit, PPR rows within rtol 2e-4 / atol 1e-6, MST
    components bit for bit and weights within rtol 1e-5."""
    import torch
    if isinstance(exp, bool):
        if type(got) is not bool or got != exp:
            raise AssertionError(f"{what}: {got!r} != {exp!r}")
    elif isinstance(exp, tuple):
        equal(f"{what} components", got[0], exp[0])
        torch.testing.assert_close(got[1], exp[1], rtol=1e-5, atol=0.0,
                                   msg=lambda m: f"{what} weight: {m}")
        equal(f"{what} edges", int(got[2]), int(exp[2]))
    elif exp.dtype == torch.float32 and what.startswith("ppr"):
        torch.testing.assert_close(got, exp, rtol=ADD_RTOL, atol=ADD_ATOL,
                                   msg=lambda m: f"{what}: {m}")
    else:
        equal(what, got, exp)


def serve_answers(svc, tickets):
    """{(graph id, query): answer} over ``tickets`` [(ticket, (graph id,
    query))], each read from ``svc``."""
    return {key: svc.result(t) for t, key in tickets}


def held_to(what, answers, want):
    """Every answer of ``answers`` against ``want``'s for the same (graph
    id, query)."""
    for (gid, q), row in answers.items():
        same_row(f"{q.kind} {what} {gid} {q}", row, want[gid, q])


def phase_serving(g, device, single, slice_one, batch):
    """Phase 10: graph serving on the card — ``GraphService`` over the
    scale-21 graph and phase 8d's eight tenants.  Returns the three graph
    kernels' launches in it."""
    import torch
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out, launches = count_launches(lambda: _phase10(g, device, single,
                                                    slice_one, batch))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"phase 10: done in {time.perf_counter() - t_phase:.1f} s (about "
        f"{out:.1f} s of it (f)'s calibration and races); peak "
        f"{peak:.2f} GiB; launches {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched in phase 10")
    return launches


def wave_tracer():
    """An enabled :class:`repro_torch.obs.trace.Tracer` for a service
    that also brackets each ``wave`` span with a CUDA event pair (no
    synchronise added: a wave with no final host read, such as a
    fixed-iteration PageRank, is timed on the card all the same).  Its
    ``split()`` gives the device ms of each wave since the last call."""
    import contextlib
    import torch
    from repro_torch.obs.trace import Tracer

    class WaveTracer(Tracer):
        def __init__(self):
            super().__init__(enabled=True)
            self.waves = []

        @contextlib.contextmanager
        def span(self, name, **kw):
            if name != "wave":
                with super().span(name, **kw):
                    yield
                return
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with super().span(name, **kw):
                yield
            end.record()
            self.waves.append((kw["args"], start, end))

        def split(self):
            """Device ms of each wave since the last call, with its
            axis, kind and width (cells of a product wave, queries of a
            lane wave, graphs of a graph batch)."""
            parts = []
            for a, start, end in self.waves:
                if a["axis"] == "product":
                    width = (f"{a['lanes']}x{a['graphs']} cells "
                             f"({a['cells']} real)")
                else:
                    width = f"x{a.get('queries', a.get('graphs'))}"
                parts.append(f"{a['axis']} {a['kind']} {width} "
                             f"{start.elapsed_time(end):.1f} ms")
            self.waves.clear()
            self.events.clear()
            return "; ".join(parts)
    return WaveTracer()


def _phase10(g, device, single, slice_one, batch):
    import os
    import shutil
    import tempfile
    import threading
    import numpy as np
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core import autotune as AT
    from repro_torch.core.commit import CommitSpec
    from repro_torch.graphs.algorithms.pagerank import personalized_pagerank
    from repro_torch.graphs.generators import random_weights
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import queries as Q
    from repro_torch.serve.continuous import ContinuousServer
    from repro_torch.serve.durable import ServiceSupervisor
    from repro_torch.serve.graph_service import GraphService
    bfs0, sssp0, _ = single
    src, far, lone, _ = slice_one
    gs, gws, srcs, tgts, tenant_runs = batch
    rng = np.random.default_rng(SEED + 10)
    others = rng.choice(np.flatnonzero(g.degrees.cpu().numpy() > 0),
                        LANES - 1, replace=False)
    hot_srcs = [src] + [int(x) for x in others]
    bursts = serving_bursts(Q, hot_srcs, [(src, far), (src, lone)], srcs,
                            tgts)
    stream = [item for b in bursts for item in b]
    again = bursts[0][0]                 # resubmitted after a drain
    graphs = {"hot": random_weights(g, seed=0)}
    graphs.update({f"t{i}": m for i, m in enumerate(gws.graphs)})
    say(f"phase 10: tenants: hot (V={g.num_vertices} E={g.num_edges}) and "
        f"{len(gws.graphs)} Kronecker scale-{TENANTS[1]} graphs; V_tot="
        f"{sum(x.num_vertices for x in graphs.values())} E_tot="
        f"{sum(x.num_edges for x in graphs.values())}; the stream: "
        f"{len(stream)} queries in 3 bursts, one duplicate, one cache hit")

    def service(backend="pallas", **kw):
        svc = GraphService(spec=CommitSpec(backend=backend, stats=False),
                           max_lanes=LANES, max_graphs=SERVE_GRAPHS, **kw)
        for gid, x in graphs.items():
            svc.register_graph(gid, x)
        return svc

    def drain_all(svc):
        tickets = [(svc.submit(gid, q), (gid, q)) for gid, q in stream]
        before = launches_since()
        done, wall = timed(svc.drain)
        launched = launches_since(before)
        if sorted(done) != sorted({t for t, _ in tickets}):
            raise AssertionError("a drain left a ticket unanswered")
        hit = svc.submit(*again)
        if hit not in svc._results:
            raise AssertionError("the resubmitted query was no cache hit")
        return serve_answers(svc, tickets), wall, launched

    # (a) the synchronous product drain: on atomic, the plain tier that
    # launches no kernel, then on pallas and fused, each held to atomic's
    # answers and fused to pallas's
    tracer = wave_tracer()
    want, stats, by_backend = None, {}, {}
    kernel_of = {"atomic": None, "pallas": "coarse_commit",
                 "fused": "fused_route_commit"}
    for backend, kernel in kernel_of.items():
        svc = service(backend, tracer=tracer)
        answers, wall, launched = drain_all(svc)
        stats[backend] = svc.stats
        say(f"phase 10a: {backend:6s} drain of {len(stream)} queries "
            f"{wall * 1e3:.1f} ms ({len(stream) / wall:.1f} queries/s); "
            f"launches {launched}; device ms by wave: {tracer.split()}")
        if kernel is None:
            if any(launched.values()):
                raise AssertionError(f"phase 10a: the atomic drain "
                                     f"launched {launched}")
            want = answers
        else:
            if launched[kernel] < 1:
                raise AssertionError(f"phase 10a: the {backend} drain did "
                                     f"not launch {kernel}")
            held_to(f"{backend} vs atomic", answers, want)
        by_backend[backend] = answers
        del svc
    held_to("fused vs pallas", by_backend["fused"], by_backend["pallas"])
    # 4 product kinds over 9 graphs: 4 lanes (2 for st-conn) x 9 cells, 12
    # (10) of them real; coloring and MST as graph batches of 8
    expect = dict(product_waves=4, product_cells=3 * 36 + 18,
                  product_cells_padded=3 * 24 + 8, graph_waves=2,
                  graphs_batched=16, waves=0, deduped=1, cache_hits=1)
    for backend, st in stats.items():
        got = {f: getattr(st, f) for f in expect}
        if got != expect:
            raise AssertionError(f"phase 10a {backend}: stats {got} != "
                                 f"{expect}")
    say(f"phase 10a: pallas and fused equal atomic and each other (BFS, "
        f"SSSP, st-conn, coloring, MST components bit for bit; PPR within "
        f"rtol 2e-4 / atol 1e-6; MST weights within rtol 1e-5); stats on "
        f"all three {expect}")

    # (b) the two-axis drain: lane waves and graph batches, equal to (a)
    # and to phases 4 and 8d
    svc = service(product=False, tracer=tracer)
    two_axis, wall_b, launched = drain_all(svc)
    st_b = svc.stats
    say(f"phase 10b: product=False drain {wall_b * 1e3:.1f} ms "
        f"({len(stream) / wall_b:.1f} queries/s); launches {launched}; "
        f"device ms by wave: {tracer.split()}")
    del svc
    held_to("two-axis vs product", two_axis, want)
    if st_b.product_waves or st_b.waves != 4 or st_b.graph_waves != 6:
        raise AssertionError(f"phase 10b: {st_b}")
    equal("hot bfs vs phase 4", want["hot", Q.BfsQuery(src)], bfs0.dist)
    equal("hot sssp vs phase 4", want["hot", Q.SsspQuery(src)], sssp0)
    colors, _, _ = tenant_runs["coloring"]
    for i, (m, s, t) in enumerate(zip(gs.graphs, srcs, tgts)):
        gid = f"t{i}"
        equal(f"{gid} bfs vs phase 8d", want[gid, Q.BfsQuery(s)],
              tenant_runs["bfs"][i])
        equal(f"{gid} sssp vs phase 8d", want[gid, Q.SsspQuery(s)],
              tenant_runs["sssp"][i])
        equal(f"{gid} st-conn vs phase 8d", want[gid, Q.StConnQuery(s, t)],
              bool(tenant_runs["stconn"][i]))
        equal(f"{gid} coloring vs phase 8d", want[gid, Q.ColoringQuery(0)],
              colors[i])
        comp, w, n = tenant_runs["boruvka"][0][i]
        same_row(f"mst {gid} vs phase 8d", want[gid, Q.MstQuery()],
                 (comp, w, n))
        ppr, _ = personalized_pagerank(m, s, iters=LANE_PPR_ITERS,
                                       spec=CommitSpec(backend="pallas",
                                                       stats=False))
        same_row(f"ppr {gid} vs a single query",
                 want[gid, Q.PprQuery(s, iters=LANE_PPR_ITERS)], ppr)
    say(f"phase 10b: the product=False drain ({st_b.waves} lane waves, "
        f"{st_b.graph_waves} graph batches) equals (a); hot's BFS and SSSP "
        f"from phase 4's source equal phase 4's; each tenant's answers "
        f"equal phase 8d's, PPR a single-query run's")

    # (c) the continuous server: two submitter threads, three bursts
    svc = service()
    started = threading.Event()

    def first_chunk(where, i):
        if where == "continuous":          # a product wave's chunk runs
            started.set()
    svc.fault_injector = first_chunk
    tickets, tlock = [], threading.Lock()

    def submit_burst(cs, items):
        def submitter(part):
            for gid, q in part:
                t = cs.submit(gid, q)
                with tlock:
                    tickets.append((t, (gid, q)))
        threads = [threading.Thread(target=submitter, args=(items[k::2],))
                   for k in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    before = launches_since()
    t0 = time.perf_counter()
    with ContinuousServer(svc, round_chunk=4) as cs:
        submit_burst(cs, bursts[0])
        if not started.wait(600):
            raise AssertionError("phase 10c: no product wave started")
        submit_burst(cs, bursts[1])        # while the first wave runs
        first = [t for t, _ in tickets[:len(bursts[0])]]
        cs.results(first, timeout=600)
        submit_burst(cs, [again] + bursts[2])
        cs.results([t for t, _ in tickets], timeout=600)
    wall = time.perf_counter() - t0
    launched = launches_since(before)
    if cs.last_error is not None:
        raise AssertionError(f"phase 10c: {cs.last_error!r}")
    h = svc.stats.registry.histogram("aam_submit_to_answer_seconds")
    if (h.count != len(tickets) or sorted(cs.done_at) != sorted(
            t for t, _ in tickets)):
        raise AssertionError(f"phase 10c: {h.count} answers for "
                             f"{len(tickets)} tickets")
    held_to("continuous vs (a)", serve_answers(svc, tickets), want)
    if not cs.boarded:
        raise AssertionError("phase 10c: no query boarded a running wave")
    st = svc.stats
    lat = [cs.done_at[t] - cs.submit_at[t] for t, _ in tickets]
    say(f"phase 10c: ContinuousServer(round_chunk=4), 2 threads, 3 bursts: "
        f"{len(tickets)} tickets answered once each, equal to (a), in "
        f"{wall:.2f} s; {cs.boarded} queries boarded a running wave; "
        f"{st.product_waves} product waves, {st.drains} drains; launches "
        f"{launched}; submit-to-answer from the histogram p50 "
        f"{h.quantile(0.5) * 1e3:.1f} ms, p99 {h.quantile(0.99) * 1e3:.1f} "
        f"ms (bucket bounds), from the tickets' times p50 "
        f"{np.percentile(lat, 50) * 1e3:.1f} ms, p99 "
        f"{np.percentile(lat, 99) * 1e3:.1f} ms")
    del svc, cs

    # (d) the supervisor: a snapshot of the first burst's queue, a fault,
    # restore and WAL replay, timed between the supervisor's own log lines
    (ROOT / "build").mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(dir=ROOT / "build")
    try:
        svc = service()
        marks = {}

        def log(msg):
            say(f"phase 10d: {msg}")
            if msg.startswith("[supervisor]"):       # restore begins
                marks["fault"] = time.perf_counter()
            elif msg.startswith("[service] restored"):
                torch.cuda.synchronize()
                marks["restored"] = time.perf_counter()
        sup = ServiceSupervisor(svc, Checkpointer(ckdir), log=log)
        tickets = [(sup.submit(gid, q), (gid, q)) for gid, q in bursts[0]]
        step, t_save = timed(sup.save)
        nbytes = sum(p.stat().st_size for p in
                     (pathlib.Path(ckdir) / f"step_{step:08d}").rglob("*")
                     if p.is_file())
        tickets += [(sup.submit(gid, q), (gid, q))
                    for gid, q in bursts[1] + bursts[2]]
        products = []

        def fault(where, i):
            if where == "product":
                products.append(i)
                if len(products) == 2:
                    raise RuntimeError("simulated host drop at the second "
                                       "product wave")
        svc.fault_injector = fault
        before = launches_since()
        done = sup.drain()
        launched = launches_since(before)
        hit = sup.submit(*again)
        tickets.append((hit, again))
        if (sup.restarts != 1 or len(products) != 2 or sup.service is svc
                or sorted(done) != [t for t, _ in tickets[:-1]]
                or hit not in done and hit not in sup.service._results
                or sup.service.pending()
                or sup.service._next_ticket != len(tickets)):
            raise AssertionError(f"phase 10d: restarts {sup.restarts}, "
                                 f"{len(done)} answered of {len(tickets)}, "
                                 f"pending {sup.service.pending()}")
        answers = serve_answers(sup.service, tickets)
        held_to("supervised vs (a)", answers, want)
        say(f"phase 10d: ServiceSupervisor: a snapshot of the first burst's "
            f"queue, {nbytes} bytes, saved in {t_save:.2f} s; a fault at "
            f"the second product wave; restore and WAL replay "
            f"{marks['restored'] - marks['fault']:.2f} s; the re-drain "
            f"answered all {len(done)} tickets once, equal to (a); the "
            f"resubmitted query a cache hit of the restored service; "
            f"launches {launched}")
        del svc, sup
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    # (e) the mesh= route at world size 1, its owner side on the fused
    # kernel
    svc = GraphService(spec=CommitSpec(backend="fused", stats=False),
                       max_lanes=LANES, max_graphs=SERVE_GRAPHS,
                       mesh=make_mesh(device=device),
                       capacity=ENGINE_CAPACITY)
    svc.register_graph("hot", graphs["hot"])
    mesh_stream = ([("hot", Q.BfsQuery(s)) for s in hot_srcs]
                   + [("hot", Q.StConnQuery(src, far)),
                      ("hot", Q.StConnQuery(src, lone))])
    before = launches_since()
    rows, wall = timed(lambda: svc.run("hot", [q for _, q in mesh_stream]))
    launched = launches_since(before)
    held_to("mesh= route vs (a)", dict(zip(mesh_stream, rows)), want)
    if not (launched["bucket_count"] and launched["fused_route_commit"]):
        raise AssertionError(f"phase 10e: launches {launched}")
    say(f"phase 10e: the mesh= route at world size 1, C = 2^24: 4 BFS lanes "
        f"and 2 st-conn queries in {wall * 1e3:.1f} ms, equal to (a); "
        f"launches {launched}")
    del svc

    # (f) a warm restore of an auto service: the first drain on the tuner
    # phase 9 warmed calibrates and races what it lacks; the restored
    # service, on a fresh tuner, times nothing
    tuner = AT.DEFAULT_TUNER
    auto_stream = [("t0", Q.BfsQuery(srcs[0])), ("t0", Q.BfsQuery(0)),
                   ("t1", Q.BfsQuery(srcs[1])), ("t0", Q.SsspQuery(srcs[0])),
                   ("t1", Q.SsspQuery(srcs[1]))]
    os.environ["REPRO_AUTOTUNE_CACHE"] = "off"
    try:
        svc = GraphService(cache=False)            # backend="auto"
        for gid in ("t0", "t1"):
            svc.register_graph(gid, graphs[gid])
        first = [svc.submit(gid, q) for gid, q in auto_stream]
        _, t_first = timed(svc.drain)
        runs0 = svc.stats.timing_runs
        queued = [svc.submit(gid, q) for gid, q in auto_stream]
        snap = svc.snapshot()
        fresh = AT.AutoTuner()
        AT.DEFAULT_TUNER = fresh
        restored = GraphService.restore(snap, device=device)
        done, t_warm = timed(restored.drain)
    finally:
        AT.DEFAULT_TUNER = tuner
        os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    if sorted(done) != queued or restored.stats.timing_runs \
            or fresh.timed_runs:
        raise AssertionError(f"phase 10f: the restored auto service timed "
                             f"{restored.stats.timing_runs} runs")
    for t_a, t_b, (gid, q) in zip(first, queued, auto_stream):
        same_row(f"{q.kind} warm auto {gid} {q}", restored.result(t_b),
                 svc.result(t_a))
    say(f"phase 10f: default-spec (auto) service over t0 and t1: the first "
        f"drain {t_first:.2f} s ({runs0} timed runs); restored on a fresh "
        f"AutoTuner, its replayed queue drained in {t_warm * 1e3:.1f} ms "
        f"with timing_runs == 0, equal to the first drain; calibration and "
        f"races, the difference: {t_first - t_warm:.2f} s")
    return t_first - t_warm


def ssd_bound(g, L, n, p, elem):
    """The least time of the SSD chunk on the card, in ms, and what sets
    it: each input read and the output written once (C, B [G, L, N], x, y
    [G, L, P] of ``elem`` bytes, a [G, L] f32) over the HBM rate, or the
    causal products (G L(L+1)/2 (N + P) FMAs, 2 FLOPs each) over the peak
    rate of the inputs' type (f32 without tensor cores, or bf16)."""
    byte_ms = g * ((2 * L * n + 2 * L * p) * elem + 4 * L) \
        / HBM_BYTES_PER_S * 1e3
    rate = F32_FLOP_PER_S if elem == 4 else BF16_FLOP_PER_S
    flop_ms = g * L * (L + 1) / 2 * (n + p) * 2 / rate * 1e3
    return max(byte_ms, flop_ms), ("bytes" if byte_ms >= flop_ms
                                   else "operations"), byte_ms, flop_ms


def ssd_check(got, exp, label):
    """Raise unless the kernel's output agrees with the plain version's:
    f32 atol 1e-4 with rtol 1e-3 (the two sum the products in other
    orders); bf16 atol 1e-2, rtol 1e-2 (both sum the same bf16 inputs in
    f32, so they part by at most one rounding of the output to bf16, 2^-7
    of it).  Returns the max abs difference."""
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: NaN or inf")
    f32 = got.dtype == torch.float32
    torch.testing.assert_close(got.float(), exp.float(),
                               atol=1e-4 if f32 else 1e-2,
                               rtol=1e-3 if f32 else 1e-2,
                               msg=lambda m: f"{label}: {m}")
    return float((got.float() - exp.float()).abs().max())


def phase_ssd_grid(g, device):
    """Phase 7: the SSD kernel against its plain version over the chunk
    lengths the mixer reaches, both widths, both dtypes.  Returns the max
    abs difference by dtype."""
    import torch
    from repro_torch.kernels.ref import ssd_chunk_ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    t0, low = time.perf_counter(), 0.0
    for L in SSD_LS:
        for n, p in SSD_NPS:
            a = -torch.rand(g, L, generator=gen, device=device) * (500.0 / L)
            low = min(low, float(torch.cumsum(a, 1).min()))
            base = [torch.randn(g, L, k, generator=gen, device=device)
                    for k in (n, n, p)]
            for dtype in err:
                args = [t.to(dtype) for t in base] + [a]
                got = ssd_chunk_kernel(*args)
                exp = ssd_chunk_ref(*args)
                torch.cuda.synchronize()
                err[dtype] = max(err[dtype], ssd_check(
                    got, exp, f"ssd_chunk/L={L}/N={n}/P={p}/{dtype}"))
    say(f"phase 7: {len(SSD_LS) * len(SSD_NPS) * len(err)} SSD cases agree "
        f"with the plain version at G={g}, L in {SSD_LS}, (N, P) in "
        f"{SSD_NPS}, f32 and bf16, cumsum(a) down to {low:.1f}, no NaN or "
        f"inf ({time.perf_counter() - t0:.1f} s); max |err| f32 "
        f"{err[torch.float32]:.3g}, bf16 {err[torch.bfloat16]:.3g}")
    return err


def rel_diff(a, b) -> float:
    """max |a - b| over the largest |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def phase_mamba2(device, max_err):
    """Phase 7: the Mamba2 serving path at full width.  Returns the SSD
    kernel's launches on the main path (one ``generate``) and its
    numbers on layer 0's inputs."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels.ref import ssd_chunk_ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
    from repro_torch.models import lm, ssm
    from repro_torch.models import model as M
    from repro_torch.obs.timing import device_ms
    from repro_torch.serve.serve_step import generate, pad_cache
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("f32 matmuls must not run in TF32 here")
    cfg = ARCHS[MAMBA]
    b, s = PROMPT

    def rcfg(dtype, use_pallas=True):
        return RunConfig(model=cfg, shape=ShapeConfig(
            "serve", s + NEW_TOKENS, b, "decode"), compute_dtype=dtype,
            use_pallas=use_pallas)
    t0 = time.perf_counter()
    model = M.init(cfg, SEED, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in model.parameters())
    say(f"phase 7: {MAMBA}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"d_inner {cfg.d_inner}, {cfg.ssm_heads} SSD heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, vocab {cfg.vocab_size} "
        f"padded to {cfg.padded_vocab}: {n_params} params drawn on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=device).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=device, dtype=torch.int32)
    bf16 = rcfg("bfloat16")

    # the main path: one generate(), launches counted
    torch.cuda.reset_peak_memory_stats()
    ssd_chunk_kernel.launches = 0
    toks, gen_s = timed(lambda: generate(
        cfg, bf16, model, {"tokens": tokens}, max_new_tokens=NEW_TOKENS,
        device=device))
    launches = ssd_chunk_kernel.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"phase 7: generate() {b} x {s} prompt tokens + {NEW_TOKENS} "
        f"greedy, bf16, kernel path: {gen_s:.2f} s, ssd_chunk launches "
        f"{launches} (one per layer), peak {peak:.2f} GiB; first tokens "
        f"{toks[:, 0].tolist()}")
    if launches != cfg.num_layers:
        raise AssertionError(f"ssd_chunk launched {launches} times in one "
                             f"prefill of {cfg.num_layers} layers")
    if toks.shape != (b, NEW_TOKENS) or toks.dtype != torch.int32 or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"generate() gave {toks.dtype} "
                             f"{tuple(toks.shape)} outside the vocab")

    # prefill and decode times
    pre = []
    for _ in range(3):
        (logits, cache), sec = timed(lambda: M.prefill(
            cfg, bf16, model, {"tokens": tokens}))
        pre.append(sec * 1e3)
    if not torch.isfinite(logits[..., :cfg.vocab_size]).all():
        raise AssertionError("prefill logits are not finite")
    cache = pad_cache(cfg, cache, s + NEW_TOKENS)
    tok = logits.argmax(-1).to(torch.int32)

    def decode():
        c, t = cache, tok
        for i in range(16):
            lg, c = M.decode_step(cfg, bf16, model, c, t, s + i)
            t = lg.argmax(-1).to(torch.int32)
    dec_ms = wall_s(decode) / 16 * 1e3
    pre_ms = statistics.median(pre)
    say(f"phase 7: prefill {b} x {s} median of 3: {pre_ms:.1f} ms "
        f"({', '.join(f'{t:.1f}' for t in pre)}), {b * s / pre_ms * 1e3:.0f} "
        f"tokens/s; decode {dec_ms:.2f} ms/token at batch {b} "
        f"({b / dec_ms * 1e3:.0f} tokens/s)")

    # the kernel against its plain version, then on layer 0's own inputs
    err = phase_ssd_grid(cfg.ssm_heads * b * s // 128, device)
    seen = []

    def record(*args):
        seen.append(args)
        return ssd_chunk_kernel(*args)
    ssm.ssd_chunk_kernel = record
    try:
        M.prefill(cfg, bf16, model, {"tokens": tokens})
    finally:
        ssm.ssd_chunk_kernel = ssd_chunk_kernel
    args = seen[0]
    (g, L, n), p = args[0].shape, args[2].shape[2]
    if args[0].dtype != torch.float32:
        raise AssertionError(f"the mixer gave the kernel {args[0].dtype}")
    # the main path's dtype: its error is the kernels line's max_abs_err
    max_err["ssd_chunk"] = max(err[torch.float32], ssd_check(
        ssd_chunk_kernel(*args), ssd_chunk_ref(*args), "ssd_chunk/layer 0"))
    ms = device_ms(lambda: ssd_chunk_kernel(*args))
    call = call_ms(lambda: ssd_chunk_kernel(*args))
    plain = device_ms(lambda: ssd_chunk_ref(*args))
    bound, by, byte_ms, flop_ms = ssd_bound(g, L, n, p,
                                            args[0].element_size())
    low = float(torch.cumsum(args[3], 1).min())
    say(f"phase 7: ssd_chunk on layer 0's inputs: G={g}, L={L}, N={n}, "
        f"P={p}, {args[0].dtype}, cumsum(a) down to {low:.1f}: kernel "
        f"device {ms:.4f} ms, call {call:.4f} ms  plain {plain:.4f} ms  bound "
        f"{bound:.4f} ms by {by} (bytes G(2LN + 2LP)e + 4GL over 3.35 TB/s "
        f"= {byte_ms:.4f} ms; G L(L+1)/2 (N + P) 2 FLOPs over 67 TFLOP/s = "
        f"{flop_ms:.4f} ms); {cfg.num_layers} x kernel / prefill = "
        f"{cfg.num_layers * ms / pre_ms:.3f}")
    # the same cells in bf16 (C, B, x cast; a stays f32)
    bf16_args = [t.to(torch.bfloat16) for t in args[:3]] + [args[3]]
    ssd_check(ssd_chunk_kernel(*bf16_args), ssd_chunk_ref(*bf16_args),
              "ssd_chunk/layer 0/bf16")
    ms_bf16 = device_ms(lambda: ssd_chunk_kernel(*bf16_args))
    bound_bf16, by_bf16, _, _ = ssd_bound(g, L, n, p, 2)
    say(f"phase 7: ssd_chunk on layer 0's inputs cast to bf16: kernel device "
        f"{ms_bf16:.4f} ms, bound {bound_bf16:.4f} ms by {by_bf16}")
    del bf16_args
    say("phase 7: library_ms for ssd_chunk is null: no one PyTorch call "
        "computes the masked, decayed C B^T x of a chunk")
    del seen, args, cache, logits

    # on-card oracles in f32
    f32, f32_plain = rcfg("float32"), rcfg("float32", use_pallas=False)
    ob, os_ = ORACLE
    short = tokens[:ob, :os_]
    with torch.no_grad():
        lk, _, _ = lm.forward(cfg, f32, model, short)
        lp, _, _ = lm.forward(cfg, f32_plain, model, short)
    d_path = rel_diff(lk[..., :cfg.vocab_size], lp[..., :cfg.vocab_size])
    del lk
    k = 8
    head, c = M.prefill(cfg, f32, model, {"tokens": short[:, :-k]})
    for pos in range(os_ - k, os_):
        head, c = M.decode_step(cfg, f32, model, c, short[:, pos, None], pos)
    d_dec = rel_diff(head[..., :cfg.vocab_size],
                     lp[:, -1:, :cfg.vocab_size])
    del lp
    mixer = model.layers[0].mixer
    x = torch.randn(2, 256, cfg.d_model, generator=gen, device=device)
    with torch.no_grad():
        y_chunk, _ = ssm.ssm_apply(cfg, mixer, x, use_pallas=True)
        y_seq = ssm.ssm_ref(cfg, mixer, x)
    d_ref = rel_diff(y_chunk, y_seq)
    say(f"phase 7: oracles, f32, {ob} x {os_} tokens: kernel path vs einsum "
        f"path logits {d_path:.3g} of the largest (bound 1e-4); prefill of "
        f"{os_ - k} + {k} decode steps vs prefill of {os_}: {d_dec:.3g} "
        f"(bound 1e-2: the prefill stores the conv cache in bf16, as the "
        f"reference does); layer 0 ssm_apply vs ssm_ref on 256 tokens "
        f"{d_ref:.3g} (bound 1e-4)")
    for what, d, bound_ in (("kernel vs einsum path", d_path, 1e-4),
                            ("decode vs prefill", d_dec, 1e-2),
                            ("ssm_apply vs ssm_ref", d_ref, 1e-4)):
        if not d <= bound_:
            raise AssertionError(f"phase 7 oracle {what}: {d} > {bound_}")
    return launches, dict(ms=ms, call_ms=call, plain_ms=plain,
                          bound_ms=bound, bound_by=by, library_ms=None)


def _lm(name, device, dtype="bfloat16", seq=0, batch=1, **cut):
    """(config, run config, model with f32 weights drawn on ``device``
    from the seed); ``cut`` replaces config fields (depth only)."""
    import dataclasses
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import model as M
    cfg = dataclasses.replace(ARCHS[name], **cut)
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("serve", seq, batch,
                                                  "decode"),
                     compute_dtype=dtype, use_pallas=True)
    return cfg, rcfg, M.init(cfg, SEED, device=device)


def serve_numbers(label, cfg, rcfg, model, tokens, new_tokens):
    """One ``generate()`` (timed, peak memory, the bucket-count kernel's
    launches in it, its counter set to 0 just before), then the prefill
    (median of 3) and 16 decode steps timed apart.  Returns a dict."""
    import torch
    from repro_torch.kernels.coalesce import bucket_count_kernel
    from repro_torch.models import model as M
    from repro_torch.serve.serve_step import generate, pad_cache
    b, s = tokens.shape
    torch.cuda.reset_peak_memory_stats()
    bucket_count_kernel.launches = 0
    toks, gen_s = timed(lambda: generate(
        cfg, rcfg, model, {"tokens": tokens}, max_new_tokens=new_tokens,
        device=tokens.device))
    launches = bucket_count_kernel.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if toks.shape != (b, new_tokens) or toks.dtype != torch.int32 or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{label}: generate() gave {toks.dtype} "
                             f"{tuple(toks.shape)} outside the vocab")
    pre = []
    for _ in range(3):
        (logits, cache), sec = timed(lambda: M.prefill(
            cfg, rcfg, model, {"tokens": tokens}))
        pre.append(sec * 1e3)
    if not torch.isfinite(logits[..., :cfg.vocab_size]).all():
        raise AssertionError(f"{label}: prefill logits are not finite")
    cache = pad_cache(cfg, cache, s + 16)
    tok = logits.argmax(-1).to(torch.int32)
    del logits

    def decode():
        c, t = cache, tok
        for i in range(16):
            lg, c = M.decode_step(cfg, rcfg, model, c, t, s + i)
            t = lg.argmax(-1).to(torch.int32)
    dec_ms = wall_s(decode) / 16 * 1e3
    pre_ms = statistics.median(pre)
    say(f"phase 11{label}: generate() {b} x {s} prompt tokens + "
        f"{new_tokens} greedy, bf16: {gen_s:.2f} s, peak {peak:.2f} GiB; "
        f"prefill median of 3: {pre_ms:.1f} ms ({', '.join(f'{t:.1f}' for t in pre)}), "
        f"{b * s / pre_ms * 1e3:.0f} tokens/s; decode {dec_ms:.2f} ms/token "
        f"at batch {b} ({b / dec_ms * 1e3:.0f} tokens/s); first tokens "
        f"{toks[:, 0].tolist()}; bucket_count launches in generate() "
        f"{launches}")
    return dict(gen_s=gen_s, prefill_ms=pre_ms, decode_ms=dec_ms, peak=peak,
                launches=launches)


def _kv_as_cached(fn):
    """``fn()`` with every self-attention K/V rounded to bf16 and back, as
    the KV cache stores them.  A decode from such a prefill's cache must
    match such a prefill of the whole sequence up to f32 rounding; on f32
    K/V the prefill of the first S - k tokens sees K/V the decode steps
    see only rounded."""
    import torch
    from repro_torch.models import attention
    project_kv = attention.project_kv

    def rounded(*args, **kw):
        k, v = project_kv(*args, **kw)
        return (k.to(torch.bfloat16).to(k.dtype),
                v.to(torch.bfloat16).to(v.dtype))
    attention.project_kv = rounded
    try:
        return fn()
    finally:
        attention.project_kv = project_kv


def _recording(module, name, sink):
    """Patch ``module.name`` with a wrapper that appends its arguments and
    result to ``sink``; returns the undo."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        sink.append((args, out))
        return out
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, fn)


def phase11_phi(device, costs13):
    """Phase 11a: phi3.5-moe at full width, 8 layers.  Returns the
    bucket-count launches of its ``generate()``, the model and the
    numbers of the count on layer 0's owner ids."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels.coalesce import bucket_count_kernel
    from repro_torch.kernels.ref import bucket_count_ref
    from repro_torch.models import lm
    from repro_torch.moe import moe_layer
    from repro_torch.obs.timing import device_ms
    b, s = PHI_PROMPT
    t0 = time.perf_counter()
    cfg, rcfg, model = _lm(PHI, device, seq=s + PHI_NEW, batch=b,
                           num_layers=PHI_LAYERS)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in model.parameters())
    full_params = ARCHS[PHI].param_count()
    n_moe = sum(spec.mlp == "moe" for spec in cfg.full_pattern) \
        * cfg.num_blocks
    say(f"phase 11a: {PHI}: d_model {cfg.d_model}, {cfg.num_heads} heads "
        f"of {cfg.head_dim} ({cfg.num_kv_heads} KV), {cfg.num_experts} "
        f"experts of {cfg.moe_d_ff}, top {cfg.experts_per_token}, vocab "
        f"{cfg.vocab_size} padded to {cfg.padded_vocab}; {cfg.num_layers} of "
        f"32 layers: {n_params} params ({n_params * 4 / 1e9:.1f} GB f32; "
        f"the whole model {full_params / 1e9:.1f} B) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=device).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=device, dtype=torch.int32)

    # the main path: one generate(), the count kernel's launches counted
    phi = serve_numbers("a", cfg, rcfg, model, tokens, PHI_NEW)
    launches = phi["launches"]
    forwards = PHI_NEW            # the prefill and PHI_NEW - 1 decode steps
    if launches != n_moe * forwards:
        raise AssertionError(f"bucket_count launched {launches} times, not "
                             f"once per MoE layer per forward "
                             f"({n_moe} x {forwards})")
    phase13_cost("phi3.5", cfg, rcfg, model, tokens, phi["prefill_ms"],
                 costs13)

    # the prefill's metrics and layer 0's owner ids
    seen = []
    undo = _recording(moe_layer, "plan_buckets_sorted", seen)
    try:
        with torch.no_grad():
            _, _, met = lm.forward(cfg, rcfg, model, tokens, mode="prefill")
    finally:
        undo()
    dropped = int(met["moe_dropped"])
    t, k, e = b * s, cfg.experts_per_token, cfg.num_experts
    cap = moe_layer._capacity(cfg, t, dropless=True)
    rows = e * cap
    flops = 2 * 3 * rows * cfg.d_model * cfg.moe_d_ff
    say(f"phase 11a: prefill moe_dropped {dropped} (dropless), moe_aux "
        f"{float(met['moe_aux']):.4f}; dropless capacity C = T k = {cap}: "
        f"{rows} expert rows for {t * k} assignments, padding share "
        f"{1 - t * k / rows:.4f}; {flops / 1e12:.1f} TFLOP of expert GEMMs "
        f"a layer, {flops * t * k / rows / 1e12:.2f} of them on real rows")
    if dropped:
        raise AssertionError(f"phase 11a: {dropped} assignments dropped")
    owner = seen[0][0][0].contiguous()
    del seen, met
    got = bucket_count_kernel(owner, e)
    exp = bucket_count_ref(owner, e)
    if not torch.equal(got, exp):
        raise AssertionError("bucket_count differs from its plain version "
                             "on layer 0's owner ids")
    ms = device_ms(lambda: bucket_count_kernel(owner, e))
    call = call_ms(lambda: bucket_count_kernel(owner, e))
    plain = device_ms(lambda: bucket_count_ref(owner, e))
    library = device_ms(lambda: torch.bincount(owner, minlength=e))
    bound = (4 * owner.numel() + 4 * e) / HBM_BYTES_PER_S * 1e3
    say(f"phase 11a: bucket_count on layer 0's owner ids (N = T k = "
        f"{owner.numel()}, {e} buckets, counts {got.tolist()}): equal to "
        f"its plain version; kernel device {ms:.4f} ms, call {call:.4f} ms "
        f" plain {plain:.4f} ms  torch.bincount {library:.4f} ms  bound "
        f"(4N + 4B) bytes / 3.35 TB/s = {bound:.6f} ms; {n_moe} x kernel / "
        f"prefill = {n_moe * ms / phi['prefill_ms']:.5f}")
    return cfg, model, phi


def phase11_phi_oracles(cfg, model, device):
    """Phase 11c on phi3.5: layer 0's MoE (aam against dense, the
    kernel-counted plan against bincount's), then decode against prefill,
    in f32."""
    import torch
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.coalescing import plan_buckets_sorted
    from repro_torch.models import lm
    from repro_torch.models import model as M
    from repro_torch.moe import moe_layer
    from repro_torch.serve.serve_step import pad_cache
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    layer = model.layers[0].mlp
    x = torch.randn(PHI_ORACLE_T, cfg.d_model, generator=gen, device=device)
    with torch.no_grad():
        ya, ma = moe_layer.moe_apply_aam(cfg, layer, x, mode="prefill")
        yd, md = moe_layer.moe_apply_dense(cfg, layer, x, mode="prefill")
        _, experts, _ = moe_layer._route(cfg, layer, x)
    d_moe = rel_diff(ya, yd)
    owner = experts.reshape(-1)
    valid = torch.ones_like(owner, dtype=torch.bool)
    cap = moe_layer._capacity(cfg, PHI_ORACLE_T, dropless=True)
    plans = [plan_buckets_sorted(owner, valid, cfg.num_experts, cap,
                                 count_backend=cb) for cb in ("pallas", "jnp")]
    same = all(torch.equal(getattr(plans[0][0], f), getattr(plans[1][0], f))
               for f in ("owner", "position", "counts", "kept", "dropped")) \
        and torch.equal(plans[0][1], plans[1][1])
    say(f"phase 11c: phi3.5 layer 0's MoE at T = {PHI_ORACLE_T}, f32: "
        f"moe_apply_aam vs moe_apply_dense {d_moe:.3g} of the largest "
        f"(bound 1e-5), moe_dropped {int(ma['moe_dropped'])} and "
        f"{int(md['moe_dropped'])}; the kernel-counted plan equals "
        f"torch.bincount's: {same}")
    if not (d_moe <= 1e-5 and same and int(ma["moe_dropped"]) == 0
            == int(md["moe_dropped"])):
        raise AssertionError("phase 11c: phi3.5 layer 0's MoE oracle")
    del ya, yd, x, plans

    ob, os_ = LM_ORACLE
    f32 = RunConfig(model=cfg, shape=ShapeConfig("o", os_, ob, "decode"),
                    compute_dtype="float32", use_pallas=True)
    toks = torch.randint(0, cfg.vocab_size, (ob, os_), generator=gen,
                         device=device, dtype=torch.int32)
    full_routes, step_routes = [], []
    with torch.no_grad():          # "prefill": dropless, as decode is
        fresh, _, _ = lm.forward(cfg, f32, model, toks, mode="prefill")
        undo = _recording(moe_layer, "_route", full_routes)
        try:
            full, _, _ = _kv_as_cached(lambda: lm.forward(
                cfg, f32, model, toks, mode="prefill"))
        finally:
            undo()
    head, c = _kv_as_cached(lambda: M.prefill(
        cfg, f32, model, {"tokens": toks[:, :-DECODE_K]}))
    c = pad_cache(cfg, c, os_)
    n_moe = sum(spec.mlp == "moe" for spec in cfg.full_pattern) \
        * cfg.num_blocks
    if len(full_routes) != n_moe:
        raise AssertionError(f"phase 11c: the prefill recorded "
                             f"{len(full_routes)} routings, not {n_moe}")
    errs, fresh_errs, same_route = [], [], []
    for pos in range(os_ - DECODE_K, os_):
        step_routes.clear()
        undo = _recording(moe_layer, "_route", step_routes)
        try:
            head, c = M.decode_step(cfg, f32, model, c, toks[:, pos, None],
                                    pos)
        finally:
            undo()
        if len(step_routes) != n_moe:
            raise AssertionError(f"phase 11c: decode step {pos} recorded "
                                 f"{len(step_routes)} routings, not {n_moe}")
        got = head[:, 0, :cfg.vocab_size]
        errs.append(rel_diff(got, full[:, pos, :cfg.vocab_size]))
        fresh_errs.append(rel_diff(got, fresh[:, pos, :cfg.vocab_size]))
        # the experts each layer chose for this position, in both runs
        same_route.append(all(torch.equal(
            step[1][1].sort(-1).values,
            whole[1][1].reshape(ob, os_, -1)[:, pos].sort(-1).values)
            for step, whole in zip(step_routes, full_routes)))
    say(f"phase 11c: phi3.5, f32, {ob} x {os_}: prefill of {os_ - DECODE_K} "
        f"+ {DECODE_K} decode steps vs the prefill of {os_}, both prefills "
        f"with their K/V rounded to bf16 as the cache stores them: by step "
        f"{', '.join(f'{e_:.3g}' for e_ in errs)} of the largest (bound "
        f"1e-3), every layer's experts equal in both runs at "
        f"{sum(same_route)} of {DECODE_K} steps (bound: all); against the "
        f"prefill on f32 K/V (no bound: the router sees other inputs there "
        f"than the bf16 cache gives decode, and a token whose experts "
        f"nearly tie may take another one): "
        f"{', '.join(f'{e_:.3g}' for e_ in fresh_errs)}")
    if not (max(errs) <= 1e-3 and all(same_route)):
        raise AssertionError(f"phase 11c: phi3.5 decode vs prefill {errs}, "
                             f"routes equal {same_route}")


def phase11_qwen(device, costs13):
    """Phase 11b: qwen2-1.5b whole."""
    import torch
    b, s = QWEN_PROMPT
    t0 = time.perf_counter()
    cfg, rcfg, model = _lm(QWEN, device, seq=s + QWEN_NEW, batch=b)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in model.parameters())
    say(f"phase 11b: {QWEN}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads ({cfg.num_kv_heads} KV) of "
        f"{cfg.head_dim}, QKV bias, tied embeddings, vocab {cfg.vocab_size}"
        f" padded to {cfg.padded_vocab}: {n_params} params drawn on the card"
        f" in {time.perf_counter() - t0:.1f} s; the LM head's bf16 logits "
        f"for all {b * s} positions take "
        f"{b * s * cfg.padded_vocab * 2 / 2 ** 30:.2f} GiB")
    gen = torch.Generator(device=device).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=device, dtype=torch.int32)
    qwen = serve_numbers("b", cfg, rcfg, model, tokens, QWEN_NEW)
    if qwen["launches"]:
        raise AssertionError("phase 11b: a dense model launched the "
                             "bucket count")
    phase13_cost("qwen2", cfg, rcfg, model, tokens, qwen["prefill_ms"],
                 costs13)
    return qwen


def phase11_gemma(device):
    """Phase 11c on gemma2-27b's published width, one local and one global
    layer: the chunked attention path against the direct one, and decode
    steps that wrap the local ring against the prefill, in f32."""
    import dataclasses
    import torch
    from repro_torch.models import lm
    from repro_torch.models import model as M
    from repro_torch.serve.serve_step import pad_cache
    s = GEMMA_SEQ
    cfg, f32, model = _lm(GEMMA, device, dtype="float32", seq=s,
                          num_layers=2)
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                         device=device, dtype=torch.int32)
    direct_cfg = dataclasses.replace(cfg, attn_chunk=s)
    with torch.no_grad():
        chunked, _, _ = lm.forward(cfg, f32, model, toks)
        fresh = chunked[:, -1, :cfg.vocab_size].clone()
        direct, _, _ = lm.forward(direct_cfg, f32, model, toks)
        d_path = rel_diff(chunked[..., :cfg.vocab_size],
                          direct[..., :cfg.vocab_size])
        del chunked, direct
        last = _kv_as_cached(lambda: lm.forward(
            cfg, f32, model, toks)[0][:, -1, :cfg.vocab_size].clone())
    head, c = _kv_as_cached(lambda: M.prefill(
        cfg, f32, model, {"tokens": toks[:, :-DECODE_K]}))
    c = pad_cache(cfg, c, s)
    ring = c[0]["pos"].shape[-1]
    for pos in range(s - DECODE_K, s):
        head, c = M.decode_step(cfg, f32, model, c, toks[:, pos, None], pos)
    d_dec = rel_diff(head[:, 0, :cfg.vocab_size], last)
    d_fresh = rel_diff(head[:, 0, :cfg.vocab_size], fresh)
    wrapped = sorted(c[0]["pos"][0].tolist()) == list(range(s - ring, s))
    say(f"phase 11c: {GEMMA} at d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads, window {cfg.sliding_window}, softcaps "
        f"{cfg.attn_softcap}/{cfg.logit_softcap}, post-norms, 2 layers "
        f"(local, global), f32, 1 x {s} tokens: chunked (chunk "
        f"{cfg.attn_chunk}) vs direct attention logits {d_path:.3g} of the "
        f"largest (bound 1e-4); prefill of {s - DECODE_K} + {DECODE_K} "
        f"decode steps vs the prefill of {s}, both prefills with their K/V "
        f"rounded to bf16 as the cache stores them: {d_dec:.3g} (bound "
        f"1e-3), vs the prefill on f32 K/V {d_fresh:.3g} (bound 1e-2); the "
        f"local ring "
        f"({ring} slots) holds positions {s - ring}..{s - 1}: {wrapped}")
    if not (d_path <= 1e-4 and d_dec <= 1e-3 and d_fresh <= 1e-2
            and wrapped):
        raise AssertionError(f"phase 11c: gemma2 oracles {d_path} {d_dec} "
                             f"{wrapped}")


def phase_lm_families(device, costs13):
    """Phase 11.  Returns the bucket-count launches of its main path
    (phi3.5's ``generate()``); phase 13d's ``cost_of`` over each model's
    prefill runs here, while the weights are on the card, into
    ``costs13``."""
    import torch
    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("f32 matmuls must not run in TF32 here")
    cfg, model, phi = phase11_phi(device, costs13)
    launches = phi["launches"]
    phase11_phi_oracles(cfg, model, device)
    del model
    torch.cuda.empty_cache()
    qwen = phase11_qwen(device, costs13)
    torch.cuda.empty_cache()
    phase11_gemma(device)
    torch.cuda.empty_cache()
    say(f"phase 11: done in {time.perf_counter() - t0:.1f} s; phi3.5 "
        f"({PHI_LAYERS} layers) prefill {phi['prefill_ms']:.1f} ms, decode "
        f"{phi['decode_ms']:.2f} ms/token, peak {phi['peak']:.2f} GiB; "
        f"qwen2-1.5b prefill {qwen['prefill_ms']:.1f} ms, decode "
        f"{qwen['decode_ms']:.2f} ms/token, peak {qwen['peak']:.2f} GiB; "
        f"bucket_count launches {launches}")
    return launches


def train_numbers(label, name, device, *, steps, microbatches, **cut):
    """Phase 12a/b: ``steps`` train steps of ``name`` (bf16 compute, f32
    weights drawn on the card, ``remat="full"``, AdamW at the reference's
    defaults) on ``TokenStream(seed=0)`` batches made before the clock
    starts.  The bucket-count counter is zeroed before the run and read
    after.  Returns a dict."""
    import dataclasses
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.coalesce import bucket_count_kernel
    from repro_torch.runtime.fault_tolerance import device_get
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (clip_by_global_norm, grads_fn,
                                              init_train_state,
                                              make_train_step)
    b, s = TRAIN_BATCH
    cfg = dataclasses.replace(ARCHS[name], **cut)
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("train", s, b, "train"),
                     compute_dtype="bfloat16", remat="full",
                     microbatches=microbatches)
    t0 = time.perf_counter()
    model, params, opt_state = init_train_state(cfg, rcfg, seed=SEED,
                                                device=device)
    step_fn = make_train_step(cfg, rcfg, model)
    stream = TokenStream(cfg, rcfg.shape, seed=0)
    batches = [stream.tensors(i, device=device) for i in range(steps)]
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    state_gb = n_params * 16 / 1e9
    say(f"phase 12{label}: {name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_params} params; f32 weights, grads, AdamW m and "
        f"v {state_gb:.1f} GB; set-up and {steps} batches in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    bucket_count_kernel.launches = 0
    ms, rows = [], []
    for i, batch in enumerate(batches):
        (params, opt_state, metrics), sec = timed(
            lambda: step_fn(params, opt_state, i, batch))
        ms.append(sec * 1e3)
        rows.append(device_get(metrics))
    launches = bucket_count_kernel.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = statistics.median(ms[1:])
    # one more step on the last batch, its three parts timed apart
    opt = make_optimizer(rcfg)
    grads, sec_g = timed(lambda: grads_fn(cfg, rcfg, model, batches[-1])[0])
    (grads, _), sec_c = timed(lambda: clip_by_global_norm(grads,
                                                          rcfg.grad_clip))
    _, sec_u = timed(lambda: opt.update(grads, opt_state, params, steps))
    del grads
    for i, (t, m) in enumerate(zip(ms, rows)):
        say(f"phase 12{label}: step {i + 1}: {t:.1f} ms, loss "
            f"{m['loss']:.4f}, ce {m['ce']:.4f}, grad norm "
            f"{m['grad_norm']:.4f}, moe_dropped {m['moe_dropped']:g}, "
            f"moe_aux {m['moe_aux']:.4f}")
    moe_layers = sum(sp.mlp == "moe" for sp in cfg.full_pattern) \
        * cfg.num_blocks
    expected = 2 * moe_layers * microbatches * steps
    say(f"phase 12{label}: {b} x {s} tokens, microbatches {microbatches}: "
        f"{step_ms:.1f} ms a step (median of steps 2-{steps}), "
        f"{b * s / step_ms * 1e3:.0f} tokens/s, peak {peak:.2f} GiB; "
        f"bucket_count launches {launches} (remat full: 2 x {moe_layers} "
        f"MoE layers x {microbatches} x {steps} steps = {expected}); a "
        f"step's parts: loss and gradients (forward, recompute, backward) "
        f"{sec_g * 1e3:.1f} ms, clip {sec_c * 1e3:.1f} ms, AdamW "
        f"{sec_u * 1e3:.1f} ms")
    if not all(math.isfinite(m[k]) for m in rows for k in ("loss",
                                                            "grad_norm")):
        raise AssertionError(f"phase 12{label}: a loss or grad norm is not "
                             f"finite")
    if launches != expected:
        raise AssertionError(f"phase 12{label}: bucket_count launched "
                             f"{launches} times, remat implies {expected}")
    return dict(step_ms=step_ms, tokens_s=b * s / step_ms * 1e3, peak=peak,
                launches=launches)


def _smoke_cfg(name, **run):
    """(config, f32 run config) of smoke ``name`` on phase 12c's batch."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
    b, s = ORACLE_TRAIN
    cfg = smoke_model(ARCHS[name])
    return cfg, RunConfig(model=cfg, shape=ShapeConfig("t", s, b, "train"),
                          compute_dtype="float32",
                          **dict(dict(remat="full"), **run))


def _smoke_train(name, device, steps, *, model=None, **run):
    """``steps`` f32 train steps of smoke ``name`` on ``device`` from the
    seed's weights (or ``model``'s).  Returns (model, params, losses)."""
    import copy
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step
    cfg, rcfg = _smoke_cfg(name, **run)
    model = copy.deepcopy(model or M.init(cfg, SEED, device="cpu")) \
        .to(device)
    params = dict(model.named_parameters())
    opt_state = make_optimizer(rcfg).init(params)
    step_fn = make_train_step(cfg, rcfg, model)
    stream = TokenStream(cfg, rcfg.shape, seed=0)
    losses = []
    for i in range(steps):
        params, opt_state, m = step_fn(params, opt_state, i,
                                       stream.tensors(i, device=device))
        losses.append(m["loss"].item())
    return model, params, losses


def _card_vs_cpu_step(base, device):
    """The first step of smoke phi3.5 from ``base``'s weights: the
    largest gradient error as a share of the CPU tests' tolerance (rtol
    1e-4, atol 1e-6; at most 1 passes), the largest parameter error after
    one AdamW update on each device from the CPU's gradients, and the
    CPU's gradients."""
    import copy
    import torch
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import grads_fn
    cfg, rcfg = _smoke_cfg(PHI)
    batch = TokenStream(cfg, rcfg.shape, seed=0).batch(0)
    models, grads = {}, {}
    for dev in ("cpu", device):
        models[dev] = copy.deepcopy(base).to(dev)
        grads[dev] = grads_fn(cfg, rcfg, models[dev], {
            k: torch.from_numpy(v).to(dev) for k, v in batch.items()})[0]
    share = max(float(((grads[device][k].cpu() - g).abs()
                       / (GRAD_ATOL + GRAD_RTOL * g.abs())).max())
                for k, g in grads["cpu"].items())
    opt = make_optimizer(rcfg)
    for dev, m in models.items():
        p = dict(m.named_parameters())
        opt.update({k: g.to(dev) for k, g in grads["cpu"].items()},
                   opt.init(p), p, 0)
    params = {dev: dict(m.named_parameters()) for dev, m in models.items()}
    update_err = max(float((params[device][k].detach().cpu() - v.detach())
                           .abs().max()) for k, v in params["cpu"].items())
    return share, update_err, grads["cpu"]


def phase12_oracles(device):
    """Phase 12c: f32 (no TF32) oracles at smoke width."""
    import shutil
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.coalescing import plan_buckets_sorted
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.coalesce import bucket_count_kernel
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.moe import moe_layer
    from repro_torch.runtime.fault_tolerance import TrainSupervisor
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    cpu = torch.device("cpu")
    base = M.init(_smoke_cfg(PHI)[0], SEED, device="cpu")
    _, p_cpu, l_cpu = _smoke_train(PHI, cpu, 3, model=base)
    sink = []
    undo = _recording(moe_layer, "plan_buckets_sorted", sink)
    bucket_count_kernel.launches = 0
    try:
        _, p_gpu, l_gpu = _smoke_train(PHI, device, 3, model=base)
    finally:
        undo()
    launches = bucket_count_kernel.launches
    # the same 3 steps on the card again: bit for bit, or not
    _, p_again, l_again = _smoke_train(PHI, device, 3, model=base)
    repeat = l_again == l_gpu and all(torch.equal(p_again[k], v)
                                      for k, v in p_gpu.items())
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    diff = {k: (p_gpu[k].detach().cpu() - v.detach()).abs()
            for k, v in p_cpu.items()}
    worst = max(diff, key=lambda k: float(diff[k].max()))
    param_err = float(diff[worst].max())
    at = int(diff[worst].argmax())
    grad_share, update_err, g_cpu = _card_vs_cpu_step(base, device)
    # every plan of the run (forward and remat recompute, each layer and
    # step) again with count_backend="jnp", torch.bincount's histogram
    same = len(sink) == launches > 0
    for args, (plan, order) in sink:
        plan_j, order_j = plan_buckets_sorted(*args, count_backend="jnp")
        same &= torch.equal(order, order_j) and all(
            torch.equal(getattr(plan, f), getattr(plan_j, f)) for f in (
                "owner", "position", "counts", "kept", "dropped"))
    say(f"phase 12c: smoke {PHI}, f32, remat full, {ORACLE_TRAIN[0]} x "
        f"{ORACLE_TRAIN[1]}, the card vs the CPU from the same weights: 3 "
        f"steps' losses {', '.join(f'{x:.6f}' for x in l_gpu)}, relative "
        f"error {loss_err:.3g} (bound {LOSS_RTOL:g}); the first step's "
        f"gradients at {grad_share:.3g} of rtol {GRAD_RTOL:g} / atol "
        f"{GRAD_ATOL:g} (bound 1); one AdamW update from the same "
        f"gradients {update_err:.3g} (bound {UPDATE_ATOL:g}); parameters "
        f"after 3 steps {param_err:.3g} (bound {PARAM_ATOL:g}), largest at "
        f"{worst}[{at}] (the CPU's first-step gradient there "
        f"{float(g_cpu[worst].reshape(-1)[at]):.3g}); a second run on the "
        f"card equal bit for bit: {repeat}; the kernel's {len(sink)} plans "
        f"({launches} launches) equal count_backend=\"jnp\"'s "
        f"(torch.bincount): {same}")
    if not (loss_err <= LOSS_RTOL and grad_share <= 1
            and update_err <= UPDATE_ATOL and param_err <= PARAM_ATOL
            and same):
        raise AssertionError("phase 12c: card vs CPU or kernel vs bincount")

    # TrainSupervisor: a fault at step 6 against an uninterrupted run
    _, p_full, _ = _smoke_train(PHI, device, 8, model=base)
    ckpt_dir = ROOT / "build" / "phase12_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg, rcfg = _smoke_cfg(PHI)
    model, params, opt_state = init_train_state(cfg, rcfg, device=device)
    model.load_state_dict(base.state_dict())
    step_fn = make_train_step(cfg, rcfg, model)
    stream = TokenStream(cfg, rcfg.shape, seed=0)
    fired = []

    def injector(step):
        if step == 6 and not fired:
            fired.append(step)
            raise RuntimeError("injected fault")

    def run_step(state, step, batch):
        p, o, m = step_fn(*state, step, batch)
        return (p, o), m
    sup = TrainSupervisor(Checkpointer(ckpt_dir), save_every=4)
    t0 = time.perf_counter()
    (params, _), final, _ = sup.run(
        (params, opt_state), run_step,
        lambda i: stream.tensors(i, device=device), start_step=0,
        num_steps=8, fail_injector=injector, log_every=4,
        log=lambda *a: None)
    sup_s = time.perf_counter() - t0
    sup_err = max(float((params[k] - p_full[k]).detach().abs().max())
                  for k in p_full)
    say(f"phase 12c: TrainSupervisor, 8 steps, save_every=4, a fault at "
        f"step 6: final step {final}, restarts {sup.restarts}, parameters "
        f"vs the uninterrupted run {sup_err:.3g} (bound {PARAM_ATOL:g}), "
        f"{sup_s:.1f} s")
    if not (final == 8 and sup.restarts == 1 and sup_err <= PARAM_ATOL):
        raise AssertionError("phase 12c: the supervisor's replay")

    # the launcher, twice on one --ckpt-dir
    ckpt_dir = ROOT / "build" / "phase12_launch"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    argv = ["--smoke", "--batch", "2", "--seq", "64", "--save-every", "2",
            "--ckpt-dir", str(ckpt_dir), "--device", str(device)]
    first = launch_train.main(argv + ["--steps", "4"])
    second = launch_train.main(argv + ["--steps", "6"])
    say(f"phase 12c: launch.train --smoke on the card: the first run "
        f"{first['start']} -> {first['final']}, the second resumed at "
        f"{second['start']} -> {second['final']}, final loss "
        f"{second['log'][-1][1]['loss']:.4f}")
    if not ((first["start"], first["final"]) == (0, 4) and
            (second["start"], second["final"]) == (4, 6)):
        raise AssertionError("phase 12c: the launcher did not resume")

    # Mamba2 trains on the plain SSD path; the kernel has no backward
    _, _, l_ssm = _smoke_train(MAMBA, device, 3)
    try:
        _smoke_train(MAMBA, device, 1, use_pallas=True)
        raised = "nothing"
    except NotImplementedError as e:
        raised = str(e)
    say(f"phase 12c: smoke {MAMBA} on the plain SSD path, 3 steps: losses "
        f"{', '.join(f'{x:.4f}' for x in l_ssm)}; use_pallas=True under "
        f"autograd raises: {raised!r}")
    if not (all(map(math.isfinite, l_ssm)) and "item 9" in raised):
        raise AssertionError("phase 12c: Mamba2 training")


def phase12_nccl(device):
    """Phase 12d: a one-rank NCCL group on a localhost store: the
    expert-parallel MoE against the aam path, and a compressed DP step
    against the dequantised single-rank mean.  Returns the bucket-count
    launches of the expert-parallel call."""
    import socket
    import torch
    import torch.distributed as dist
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.coalesce import bucket_count_kernel
    from repro_torch.models import model as M
    from repro_torch.moe import moe_layer, shmap_moe
    from repro_torch.train import grad_compression as GC
    from repro_torch.train.optimizer import make_optimizer
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = shmap_moe.make_expert_mesh(1, 1, device=device)
        cfg = smoke_model(ARCHS[PHI])
        p = moe_layer.MoE(cfg, torch.Generator(device=device).manual_seed(
            SEED))
        gen = torch.Generator(device=device).manual_seed(SEED + 1)
        x = torch.randn(512, cfg.d_model, generator=gen, device=device)
        with torch.no_grad():
            y0, m0 = moe_layer.moe_apply(cfg, p, x, impl="aam", mode="train")
        shmap_moe.place_experts(p, mesh)
        bucket_count_kernel.launches = 0
        y1, m1 = moe_layer.moe_apply(cfg, p, x, impl="aam_shmap",
                                     mode="train")
        launches = bucket_count_kernel.launches
        (y1.square().sum() + m1["moe_aux"]).backward()
        y1, aux1 = y1.detach(), m1["moe_aux"].detach()
        err = float((y1 - y0).abs().max())
        before = {n: w.grad.clone() for n, w in p.named_parameters()}
        reduced = shmap_moe.reduce_expert_grads(
            p, mesh, {n: w.grad for n, w in p.named_parameters()})
        grads = all(bool(torch.isfinite(g).all()) and torch.equal(
            g, before[n]) for n, g in reduced.items())
        say(f"phase 12d: NCCL {dist.get_backend()}, 1 rank: "
            f"moe_apply(aam_shmap, train) vs aam on {x.shape[0]} tokens: "
            f"{err:.3g} (bound 1e-6), moe_dropped {int(m1['moe_dropped'])} "
            f"vs {int(m0['moe_dropped'])}, moe_aux {float(aux1):.6f}"
            f" vs {float(m0['moe_aux']):.6f}; finite gradients, unchanged "
            f"by reduce_expert_grads on one rank: {grads}; "
            f"bucket_count launches {launches}")
        if not (err <= 1e-6 and torch.equal(m0["moe_dropped"],
                                            m1["moe_dropped"])
                and abs(float(aux1 - m0["moe_aux"])) <= 1e-6
                and grads and launches == 1):
            raise AssertionError("phase 12d: aam_shmap vs aam")

        qcfg = smoke_model(ARCHS[QWEN])
        rcfg = RunConfig(model=qcfg, shape=ShapeConfig("t", 64, 4, "train"),
                         compute_dtype="float32", remat="none")
        model = M.init(qcfg, SEED, device=device)
        twin = M.init(qcfg, SEED, device=device)
        opt = make_optimizer(rcfg)
        batch = TokenStream(qcfg, rcfg.shape, seed=0).tensors(0,
                                                              device=device)
        params = dict(model.named_parameters())
        step = GC.make_compressed_dp_step(
            lambda p_, b_: M.loss_fn(qcfg, rcfg, model, b_), opt,
            dist.group.WORLD)
        sink = []
        undo = _recording(GC, "compressed_psum_mean", sink)
        try:
            params, _, ef2, loss = step(params, opt.init(params),
                                        GC.init_error_feedback(params), 0,
                                        batch)
        finally:
            undo()
        # the expectation: the step's own gradients quantised and
        # dequantised on this rank, and one update of a twin from them
        (grads, ef, _), (mean, new_ef) = sink[0]
        deq_ok = True
        for k, gk in grads.items():
            q, scale, err = GC._quantize(gk, ef[k])
            deq_ok &= torch.equal(mean[k], q.float() * scale) and \
                torch.equal(new_ef[k], err) and torch.equal(ef2[k], err)
        tp = dict(twin.named_parameters())
        tp, _ = opt.update(mean, opt.init(tp), tp, 0)
        perr = max(float((params[k] - tp[k]).detach().abs().max())
                   for k in tp)
        say(f"phase 12d: make_compressed_dp_step on the NCCL group "
            f"(all_gather of int8 payloads and f32 scales): loss "
            f"{loss.item():.4f}; the mean equals the dequantised int8 "
            f"gradients and the error feedback their residual: {deq_ok}; "
            f"parameters vs one update from them {perr:.3g} (bound 1e-6)")
        if not (deq_ok and perr <= 1e-6):
            raise AssertionError("phase 12d: compressed DP step")
    finally:
        dist.destroy_process_group()
    return launches


def phase_training(device):
    """Phase 12.  Returns the bucket-count launches of its main path
    (phi3.5's train steps)."""
    import torch
    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("f32 matmuls must not run in TF32 here")
    phi = train_numbers("a", PHI, device, steps=PHI_TRAIN_STEPS,
                        microbatches=1, num_layers=PHI_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    qwen = train_numbers("b", QWEN, device, steps=QWEN_TRAIN_STEPS,
                         microbatches=2)
    torch.cuda.empty_cache()
    phase12_oracles(device)
    phase12_nccl(device)
    say(f"phase 12: done in {time.perf_counter() - t0:.1f} s; phi3.5 "
        f"({PHI_TRAIN_LAYERS} layers) {phi['step_ms']:.1f} ms a step, "
        f"{phi['tokens_s']:.0f} tokens/s, peak {phi['peak']:.2f} GiB; "
        f"qwen2-1.5b {qwen['step_ms']:.1f} ms a step, "
        f"{qwen['tokens_s']:.0f} tokens/s, peak {qwen['peak']:.2f} GiB; "
        f"bucket_count launches {phi['launches']}")
    return phi["launches"]


# -- phase 13: the static analysis and the FLOP counter on the card ---------

PLANTED_RACE = """
\"\"\"Planted violations: a raw scatter into round state and an unscoped
launch of the fused route+commit kernel op, on the card.\"\"\"
import torch

from repro_torch.kernels.fused_wave import fused_route_commit_kernel

_V = 16
_SRC = torch.arange(_V, device="cuda")
_DST = (torch.arange(_V, dtype=torch.int32, device="cuda") * 5 + 3) % _V


def _racy_round(state):
    dist = state["dist"]
    relax = dist[_SRC] + 1
    return {"dist": dist.scatter_reduce_(0, _DST.long(), relax, "amin")}


def _unscoped_kernel_round(state):
    dist = state["dist"]
    relax = dist[_SRC] + 1
    return {"dist": fused_route_commit_kernel(dist, _DST, relax, op="min")}


LINT_TRACEABLES = (
    ("planted: racy bfs round", _racy_round,
     {"dist": torch.zeros((_V,), dtype=torch.int32, device="cuda")}),
    ("planted: unscoped fused-kernel commit", _unscoped_kernel_round,
     {"dist": torch.zeros((_V,), dtype=torch.int32, device="cuda")}),
)
"""


def all_kernels():
    """The four kernels' wrappers, by name."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
    return {**graph_kernels(), "ssd_chunk": ssd_chunk_kernel}


def count_all(fn):
    """``fn()``, its host seconds (synchronised at both ends) and the
    launches of the four kernels in it, the counters set to 0 first."""
    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    out, sec = timed(fn)
    return out, sec, {name: k.launches for name, k in kernels.items()}


def _lint(argv):
    """(exit code, printed text) of ``repro_torch.analysis.lint.main``."""
    import contextlib
    import io
    from repro_torch.analysis import lint
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint.main(argv)
    return rc, buf.getvalue()


def phase13_lint(device):
    """Phase 13a and b: aamlint on the card over every tier, then on a
    planted module.  Returns the kernels' launches in them."""
    import re
    import tempfile
    from repro_torch.core.commit import BACKENDS
    total = {}
    for backend in BACKENDS:
        (rc, out), sec, launched = count_all(lambda: _lint(
            ["--device", "cuda", "--trace-off-clean", "--backend", backend]))
        if rc != 0:
            raise AssertionError(f"phase 13a: aamlint --backend {backend} "
                                 f"exited {rc}:\n{out[-4000:]}")
        entries = [(int(c), int(k)) for c, k in re.findall(
            r"waverace .*: ok \(commits=(\d+), kernel commits=(\d+)", out)]
        if len(entries) != 22 or min(c for c, _ in entries) < 1:
            raise AssertionError(f"phase 13a: {backend}: {len(entries)} "
                                 f"clean entries with a commit, not 22")
        scoped = sum(k for _, k in entries)
        commit_launches = (launched["coarse_commit"]
                           + launched["fused_route_commit"])
        if scoped != commit_launches or (backend in ("pallas", "fused")
                                         and not scoped):
            raise AssertionError(f"phase 13a: {backend}: {scoped} scoped "
                                 f"kernel commits, {commit_launches} "
                                 f"commit-kernel launches")
        if "trace-off control" not in out:
            raise AssertionError("phase 13a: the trace-off check did not "
                                 "run its positive control")
        say(f"phase 13a: aamlint --device cuda --trace-off-clean --backend "
            f"{backend}: exit 0 in {sec:.1f} s; 22 entries clean, commits "
            f"{sum(c for c, _ in entries)}, scoped kernel commits {scoped} "
            f"= commit-kernel launches {commit_launches}; launches "
            f"{launched}")
        total = {n: total.get(n, 0) + v for n, v in launched.items()}
    name = "planted_race_card"
    with tempfile.TemporaryDirectory() as d:
        pathlib.Path(d, f"{name}.py").write_text(PLANTED_RACE)
        sys.path.insert(0, d)
        try:
            (rc, out), sec, launched = count_all(lambda: _lint(
                ["--device", "cuda", "--skip-waverace", "--module", name]))
        finally:
            sys.path.remove(d)
            sys.modules.pop(name, None)
    found = [line for line in out.splitlines() if "FINDING" in line]
    if rc != 1 or len(found) != 2 \
            or "raw aten::scatter_reduce_" not in found[0] \
            or "kernel launch (repro_torch::fused_route_commit)" \
            not in found[1]:
        raise AssertionError(f"phase 13b: the planted module gave exit {rc} "
                             f"and {found}")
    say(f"phase 13b: aamlint on a planted module: exit 1 with exactly the "
        f"raw-scatter and unscoped-kernel findings, {sec:.1f} s")
    return {n: total.get(n, 0) + v for n, v in launched.items()}


def phase13_rounds(g, device, round_ms):
    """Phase 13c: one round of each of the six algorithms on phase 4's
    graph, on ``pallas`` and ``fused``, untraced and under the race pass.
    Returns the kernels' launches and the seconds it took."""
    import torch
    from repro_torch.analysis import waverace
    from repro_torch.core.commit import CommitSpec
    from repro_torch.graphs.algorithms import (bfs, boruvka, coloring,
                                               pagerank, sssp, stconn)
    from repro_torch.launch.mesh import make_mesh
    t_part = time.perf_counter()
    mesh = make_mesh(device=device)
    src = int(torch.argmax(g.degrees))
    t = 0 if src else 1
    points = [
        ("bfs", lambda: bfs.distributed_bfs(mesh, g, src)),
        ("sssp", lambda: sssp.distributed_sssp(mesh, g, src)),
        ("pagerank", lambda: pagerank.distributed_pagerank(mesh, g)),
        ("coloring", lambda: coloring.distributed_coloring(mesh, g)),
        ("stconn", lambda: stconn.distributed_stconn(mesh, g, src, t)),
        ("boruvka", lambda: boruvka.distributed_boruvka(mesh, g)),
    ]
    caps = waverace.capture_algorithms(points)
    total = {}
    for backend in ("pallas", "fused"):
        spec = CommitSpec(backend=backend, stats=False)
        for label, cap in caps:
            state0, step = waverace.round_of(cap, spec)
            step(state0)                                  # warm-up
            _, plain_s = timed(lambda: step(state0))
            rep, traced_s, launched = count_all(
                lambda: waverace.check_traceable(label, step, state0))
            if not rep.ok or rep.commits < 1 or rep.kernel_commits < 1 \
                    or rep.kernel_commits != launched["coarse_commit"] \
                    + launched["fused_route_commit"]:
                raise AssertionError(f"phase 13c: {backend} {label}: {rep}, "
                                     f"launches {launched}")
            p4 = round_ms[backend].get(label)
            say(f"phase 13c: {backend:6s} {label:8s} one round on the "
                f"scale-21 graph: traced {traced_s * 1e3:.2f} ms, untraced "
                f"{plain_s * 1e3:.2f} ms (recorder and walk "
                f"{(traced_s - plain_s) * 1e3:+.2f} ms)"
                + (f", phase 4 {p4:.2f} ms a round" if p4 else "")
                + f"; clean, commits {rep.commits}, scoped kernel commits "
                f"{rep.kernel_commits} = launches, state reads {rep.reads}")
            total = {n: total.get(n, 0) + v for n, v in launched.items()}
            del state0, step
    return total, time.perf_counter() - t_part


def phase13_cost(label, cfg, rcfg, model, tokens, prefill_ms, sink):
    """Phase 13d: ``cost_of`` over a whole prefill of phase 11's model,
    through the op recorder; the result goes into ``sink``."""
    import torch
    from repro_torch.analysis.optrace import record
    from repro_torch.models import model as M
    from repro_torch.moe import moe_layer
    from repro_torch.runtime.flops import op_cost, records_cost
    (_, rec), sec, launched = count_all(lambda: record(
        M.prefill, cfg, rcfg, model, {"tokens": tokens}))
    cost = records_cost(rec.records)
    b, s = tokens.shape
    counted = cost.calls.get("repro_torch::bucket_count", 0)
    n_moe = sum(spec.mlp == "moe" for spec in cfg.full_pattern) \
        * cfg.num_blocks
    if counted != n_moe or launched["bucket_count"] != n_moe:
        raise AssertionError(f"phase 13d: {label}: {counted} bucket-count "
                             f"ops and {launched['bucket_count']} launches "
                             f"for {n_moe} MoE layers")
    if not (cost.dot_flops > 0 and cost.flops >= cost.dot_flops
            and cost.bytes > 0):
        raise AssertionError(f"phase 13d: {label}: {cost}")
    extra = ""
    if n_moe:
        t, e = b * s, cfg.num_experts
        cap = moe_layer._capacity(cfg, t, dropless=True)
        expert = sum(op_cost(r).dot_flops for r in rec.records
                     if r.name == "aten::bmm"
                     and tuple(r.args[0].shape[:2]) == (e, cap))
        real = t * cfg.experts_per_token / (e * cap)
        extra = (f"; expert GEMMs {expert:.4g} of the dot FLOPs "
                 f"({expert / cost.dot_flops:.3f}), on {e} x {cap} rows "
                 f"of which {t * cfg.experts_per_token} are real: padding "
                 f"share {1 - real:.4f}, {expert * (1 - real):.4g} FLOPs")
    bound_ms = cost.dot_flops / BF16_FLOP_PER_S * 1e3
    say(f"phase 13d: cost_of({label} prefill {b} x {s}): FLOPs "
        f"{cost.flops:.6g}, dot FLOPs {cost.dot_flops:.6g}, bytes "
        f"{cost.bytes:.6g} (unfused upper bound), {len(rec.records)} ops, "
        f"bucket-count ops {counted} = launches {launched['bucket_count']}"
        f"{extra}; the dot FLOPs at 989 TFLOP/s take {bound_ms:.1f} ms of "
        f"the prefill's {prefill_ms:.1f}; the recorded prefill took "
        f"{sec * 1e3:.1f} ms")
    sink[label] = (launched, sec)
    del rec
    torch.cuda.empty_cache()


def phase13_mamba(device):
    """Phase 13e: smoke Mamba2's prefill on the SSD kernel counts the dot
    FLOPs of the plain path."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
    from repro_torch.models import model as M
    from repro_torch.runtime.flops import cost_of
    b, s = ORACLE_TRAIN
    cfg = smoke_model(ARCHS[MAMBA])
    model = M.init(cfg, SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                     device=device, dtype=torch.int32)}
    costs, launched = {}, {}
    for use_pallas in (True, False):
        rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", s, b, "prefill"),
                         compute_dtype="float32", use_pallas=use_pallas)
        costs[use_pallas], _, launched[use_pallas] = count_all(
            lambda: cost_of(M.prefill, cfg, rcfg, model, batch))
    k, p = costs[True], costs[False]
    layers = cfg.num_layers
    if k.dot_flops != p.dot_flops \
            or k.calls.get("repro_torch::ssd_chunk") != layers \
            or launched[True]["ssd_chunk"] != layers \
            or launched[False]["ssd_chunk"]:
        raise AssertionError(f"phase 13e: kernel path {k.dot_flops} dot "
                             f"FLOPs, {k.calls.get('repro_torch::ssd_chunk')}"
                             f" SSD ops, {launched}; plain path "
                             f"{p.dot_flops}")
    say(f"phase 13e: smoke {MAMBA} prefill {b} x {s}, f32: dot FLOPs on the "
        f"SSD kernel {k.dot_flops:.6g} = the plain path's {p.dot_flops:.6g} "
        f"({layers} SSD ops, {layers} launches); FLOPs {k.flops:.6g} / "
        f"{p.flops:.6g}")
    return {n: launched[True][n] + launched[False][n] for n in KERNELS}


def phase_analysis(device, rounds, costs):
    """Phase 13: the remaining parts (a, b, e) after phase 12, then the
    phase's summary with parts c and d, which ran where their data was.
    Returns the kernels' launches in the phase."""
    t0 = time.perf_counter()
    launches = phase13_lint(device)
    mamba = phase13_mamba(device)
    parts = [launches, mamba, rounds[0]] + [v[0] for v in costs.values()]
    total = {n: sum(part.get(n, 0) for part in parts) for n in KERNELS}
    sec = time.perf_counter() - t0 + rounds[1] + sum(
        v[1] for v in costs.values())
    say(f"phase 13: done in {sec:.1f} s (c {rounds[1]:.1f} s after phase "
        f"10, d {sum(v[1] for v in costs.values()):.1f} s in phase 11); "
        f"launches {total}")
    for name, count in total.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched in phase 13")
    return total


# -- phase 14: the parallel layouts and the dry run -------------------------

SHARD_STEPS = 2                    # phase 14a: f32 steps, each path
SHARD_ATOL = 1e-6                  # phase 14a: parameters, sharded vs not
PIPE_MB = (2, 1, 2048)             # phase 14b: microbatches x batch x seq
PIPE_LOGIT_ATOL, PIPE_GRAD_ATOL = 1e-5, 1e-4
PIPE_TIMEOUT_S = 300
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k", False),
                ("qwen2-1.5b", "prefill_32k", False),
                ("qwen2-1.5b", "decode_32k", False),
                (PHI, "train_4k", True))


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _phi_train_cfg():
    """(config, f32 run config) of phase 14a: phi3.5 at its published
    width, phase 12a's depth and batch."""
    import dataclasses
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    b, s = TRAIN_BATCH
    cfg = dataclasses.replace(ARCHS[PHI], num_layers=PHI_TRAIN_LAYERS)
    return cfg, RunConfig(model=cfg, shape=ShapeConfig("train", s, b,
                                                       "train"),
                          compute_dtype="float32", remat="full")


def phase14_sharded(device):
    """Phase 14a: ``make_sharded_train_step`` on a one-rank NCCL group
    (``make_host_mesh(1, 1)``: the tensor-parallel step on a model axis of
    one), parameters and AdamW state as DTensors, against
    ``make_train_step`` from the same seed, the two run in turn.  Returns
    the bucket-count launches of the sharded steps and the unsharded
    run's parameters (on the host), losses and gradient norms, phase
    15a's oracle."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.coalesce import bucket_count_kernel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import sharding as shd
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (RULES, init_train_state,
                                              make_sharded_train_step,
                                              make_train_step)
    cfg, rcfg = _phi_train_cfg()
    opt = make_optimizer(rcfg)
    stream = TokenStream(cfg, rcfg.shape, seed=0)
    batches = [stream.tensors(i, device=device) for i in range(SHARD_STEPS)]

    def run(sharded):
        model, params, opt_state = init_train_state(cfg, rcfg, opt,
                                                    seed=SEED, device=device)
        if sharded:
            params = shd.shard_tree(params, RULES, mesh)
            opt_state = shd.shard_tree(opt_state, RULES, mesh)
            del model
            step = make_sharded_train_step(cfg, rcfg, opt, mesh, RULES)
        else:
            step = make_train_step(cfg, rcfg, model, opt)
        torch.cuda.synchronize()
        bucket_count_kernel.launches = 0
        ms, losses, gnorms = [], [], []
        for i, batch in enumerate(batches):
            (params, opt_state, m), sec = timed(
                lambda: step(params, opt_state, i, batch))
            ms.append(sec * 1e3)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        kinds = {type(v) is DTensor for v in params.values()} | {
            type(v) is DTensor for _, v in shd.tree_items(opt_state)}
        out = {k: (v.to_local() if sharded else v).detach().cpu()
               for k, v in params.items()}
        launches = bucket_count_kernel.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del params, opt_state, step
        torch.cuda.empty_cache()
        return out, ms, losses, launches, kinds, peak, gnorms

    torch.cuda.reset_peak_memory_stats()
    want, ms0, l0, launches0, _, peak0, g0 = run(False)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_host_mesh(1, 1)
        torch.cuda.reset_peak_memory_stats()
        got, ms1, l1, launches, kinds, peak1, _ = run(True)
    finally:
        dist.destroy_process_group()
    err = max(float((got[k] - w).abs().max()) for k, w in want.items())
    moe_layers = sum(sp.mlp == "moe" for sp in cfg.full_pattern) \
        * cfg.num_blocks
    expected = 2 * moe_layers * SHARD_STEPS
    b, s = TRAIN_BATCH
    say(f"phase 14a: {PHI} at d_model {cfg.d_model}, {cfg.num_layers} "
        f"layers, f32, remat full, AdamW, {b} x {s} tokens, {SHARD_STEPS} "
        f"steps: make_sharded_train_step on NCCL 1 rank, "
        f"make_host_mesh(1, 1), parameters and AdamW state DTensors: "
        f"{kinds == {True}}; ms a step {', '.join(f'{x:.1f}' for x in ms1)} "
        f"(unsharded {', '.join(f'{x:.1f}' for x in ms0)}); losses "
        f"{', '.join(f'{x:.6f}' for x in l1)} (unsharded "
        f"{', '.join(f'{x:.6f}' for x in l0)}); parameters vs the unsharded "
        f"step {err:.3g} (bound {SHARD_ATOL:g}); peak {peak1:.2f} GiB "
        f"(unsharded {peak0:.2f}); bucket_count launches {launches} "
        f"(remat full: 2 x {moe_layers} MoE layers x {SHARD_STEPS} steps = "
        f"{expected}; unsharded {launches0})")
    if not (kinds == {True} and err <= SHARD_ATOL and launches == expected
            and all(math.isfinite(x) for x in l1)):
        raise AssertionError("phase 14a: sharded step vs unsharded")
    return launches, {"params": want, "losses": l0, "grad_norms": g0,
                      "ms": ms0, "peak": peak0}


def _phase14_rank(rank, world, port, out_path):
    """One stage of phase 14b: gloo rank ``rank`` of ``world``, on
    ``cuda:0``.  Writes its results to ``out_path``."""
    import dataclasses
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels.coalesce import bucket_count_kernel
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.train import pipeline as PP
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out = {"rank": rank}
    try:
        nmb, b, s = PIPE_MB
        cfg = dataclasses.replace(ARCHS[PHI], num_layers=world)
        rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", s, nmb * b,
                                                      "train"),
                         compute_dtype="float32", remat="full")
        gen = torch.Generator(device=device).manual_seed(SEED + 7)
        tokens = torch.randint(0, cfg.vocab_size, (nmb * b, s),
                               generator=gen, device=device,
                               dtype=torch.int32)
        labels = torch.randint(0, cfg.vocab_size, (nmb * b, s),
                               generator=gen, device=device)

        def loss_of(logits):      # mean over microbatches of each one's CE
            return sum(F.cross_entropy(
                logits[i * b:(i + 1) * b].float().flatten(0, 1),
                labels[i * b:(i + 1) * b].flatten())
                for i in range(nmb)) / nmb

        model = M.init(cfg, SEED, device=device)
        mesh = make_mesh(axis="pod", group=dist.group.WORLD, device=device)
        mine = set(PP.stage_layers(cfg, rank, world))

        def held(name):
            head, _, rest = name.partition(".")
            if head == "layers":
                return int(rest.split(".")[0]) in mine
            if head == "embed":
                return rank in (0, world - 1)
            return rank == world - 1

        # the oracle: the plain forward of each microbatch alone
        want = torch.cat([M._forward(cfg, rcfg, model,
                                     {"tokens": tokens[i * b:(i + 1) * b]},
                                     "train")[0] for i in range(nmb)])
        loss_of(want).backward()
        want = want.detach()
        want_g = {k: p.grad.detach().clone()
                  for k, p in model.named_parameters() if held(k)}
        model.zero_grad(set_to_none=True)
        PP.keep_stage(cfg, model, mesh, "pod")
        torch.cuda.empty_cache()
        f = PP.pipeline_forward(cfg, rcfg, mesh, "pod", nmb)
        dist.barrier()
        torch.cuda.synchronize()
        bucket_count_kernel.launches = 0
        t0 = time.perf_counter()
        logits = f(model, tokens)
        loss_of(logits).backward()
        torch.cuda.synchronize()
        out["stage_s"] = time.perf_counter() - t0
        out["launches"] = bucket_count_kernel.launches
        out["logit_err"] = float((logits.detach() - want).abs().max())
        got_g = {k: p.grad for k, p in model.named_parameters()
                 if p.grad is not None}
        out["grads"] = set(got_g) <= set(want_g) and all(
            any(k.startswith(f"layers.{l}.") for k in got_g) for l in mine)
        out["grad_err"] = max(float((got_g[k] - want_g[k]).abs().max())
                              for k in got_g)
        out["grad_scale"] = max(float(g.abs().max()) for g in want_g.values())
        out["staged"] = f.link.host_staged
        out["bytes_sent"] = f.link.bytes_sent
        out["bytes_back"] = f.link.bytes_back
        out["logit_bytes"] = logits.numel() * logits.element_size()
        out["layers"] = sorted(mine)
        out["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    except BaseException as e:   # noqa: BLE001 — reported by the parent
        import traceback
        out["error"] = "".join(traceback.format_exception(e))
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as fh:
        json.dump(out, fh)


def phase14_pipeline(device):
    """Phase 14b: ``pipeline_forward`` on 2 gloo ranks, both on ``cuda:0``
    (boundary tensors staged through the host), against each
    microbatch's plain forward.  Returns the bucket-count launches of the
    pipelined runs."""
    import torch
    import torch.multiprocessing as mp
    world = 2
    out_dir = ROOT / "build" / "phase14_pipeline"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = [out_dir / f"rank{r}.json" for r in range(world)]
    for p in paths:
        p.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    port = _free_port()
    t0 = time.perf_counter()
    procs = []
    mpc = mp.get_context("spawn")
    for r in range(world):
        p = mpc.Process(target=_phase14_rank,
                        args=(r, world, port, str(paths[r])))
        p.start()
        procs.append(p)
    try:
        for p in procs:
            p.join(max(PIPE_TIMEOUT_S - (time.perf_counter() - t0), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    if not all(p.exists() for p in paths):
        raise AssertionError(f"phase 14b: a stage wrote no result "
                             f"(exit codes {[p.exitcode for p in procs]})")
    ranks = [json.loads(p.read_text()) for p in paths]
    for r in ranks:
        if "error" in r:
            raise AssertionError(f"phase 14b: rank {r['rank']}:\n"
                                 f"{r['error']}")
    nmb, b, s = PIPE_MB
    for r in ranks:
        say(f"phase 14b: stage {r['rank']} (layers {r['layers']}): forward "
            f"and backward {r['stage_s'] * 1e3:.1f} ms; logits vs each "
            f"microbatch's plain forward {r['logit_err']:.3g} (bound "
            f"{PIPE_LOGIT_ATOL:g}); its gradients {r['grad_err']:.3g} "
            f"(bound {PIPE_GRAD_ATOL:g}; largest gradient "
            f"{r['grad_scale']:.3g}); activations sent {r['bytes_sent']} "
            f"B, gradients sent back {r['bytes_back']} B, logits "
            f"broadcast {r['logit_bytes']} B; peak {r['peak']:.2f} GiB; "
            f"bucket_count launches {r['launches']}")
    launches = sum(r["launches"] for r in ranks)
    say(f"phase 14b: {PHI} at full width, 2 stages of 1 block, {nmb} "
        f"microbatches of {b} x {s}, f32, remat full, gloo with boundary "
        f"tensors through host memory (host_staged "
        f"{[r['staged'] for r in ranks]}), both ranks on cuda:0; "
        f"{time.perf_counter() - t0:.1f} s with the ranks' start")
    ok = all(r["logit_err"] <= PIPE_LOGIT_ATOL and r["grads"] and
             r["grad_err"] <= PIPE_GRAD_ATOL and r["staged"] for r in ranks)
    ok &= ranks[0]["bytes_sent"] == nmb * b * s * 4096 * 4 == \
        ranks[1]["bytes_back"]
    if not ok or launches != 2 * 2 * nmb:
        raise AssertionError(f"phase 14b: pipeline vs plain forward "
                             f"(launches {launches})")
    return launches


def start_dryrun(cells, out):
    """One ``python -m repro_torch.launch.dryrun`` process a cell (``(arch,
    shape, multi_pod)``, and a tuple of more options as a fourth entry
    where there is one), all started at once at the lowest priority (host
    work on fake tensors, beside the card's phases, on the cores this
    process leaves idle); ``finish_dryrun`` waits for them."""
    import os
    import shutil
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, multi_pod, *more in cells:
        flags = list(more[0]) if more else []
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(out)] + flags
        if multi_pod:
            cmd.append("--multi-pod")
        log = open(out / f"{arch}__{shape}__{int(multi_pod)}"
                   f"{''.join(flags)}.log", "w")
        procs.append((arch, shape, multi_pod,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT, env=env,
                                       preexec_fn=lambda: os.nice(19)),
                      log))
    return procs


def finish_dryrun(procs, timeout_s):
    """Wait for the dry-run processes (killing any left at
    ``timeout_s``)."""
    t_end = time.perf_counter() + timeout_s
    try:
        for arch, shape, multi_pod, proc, log in procs:
            proc.wait(timeout=max(t_end - time.perf_counter(), 1))
            log.close()
            if proc.returncode:
                raise AssertionError(f"dry run {arch} x {shape} exited "
                                     f"{proc.returncode}: "
                                     f"{pathlib.Path(log.name).read_text()}")
    finally:
        stop_dryrun(procs)


def stop_dryrun(procs):
    """Kill the dry-run processes still running."""
    for *_, proc, log in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        log.close()


def dryrun_rows(label, cells, out, tag="", quiet=False):
    """Print each cell's record (``tag``: the suffix its ``--tag`` gave
    it) and its roofline row; returns the rows (``quiet``: no print)."""
    from repro_torch.launch import roofline as R
    rows = []
    for arch, shape, multi_pod, *_ in cells:
        mesh = "2x16x16" if multi_pod else "16x16"
        path = out / f"{arch}__{shape}__{mesh}{tag}.json"
        if not path.exists():
            raise AssertionError(f"{label}: no dry-run record {path.name}")
        rec = json.loads(path.read_text())
        rows.append(rec)
        if quiet:
            continue
        tot = rec["collectives"]["totals"]
        t = R.terms(rec)
        say(f"{label}: {arch} x {shape} on {rec['mesh']}: host s op_cost "
            f"{rec['host_s']['op_cost']:.1f}, sharded run "
            f"{rec['host_s']['sharded_run']:.1f} (at the lowest priority); "
            f"state "
            f"{rec['state_bytes_per_device'] / 2 ** 30:.3f} GiB a device; "
            f"op flops {rec['op_cost']['flops']:.4e}, dot "
            f"{rec['op_cost']['dot_flops']:.4e}, bytes "
            f"{rec['op_cost']['bytes_unfused']:.4e}; rank 0 flops "
            f"{rec['device_cost']['flops']:.4e}; collectives "
            f"{tot['count']}, result {tot['result_bytes']} B, wire "
            f"{tot['wire_bytes']} B a device "
            f"({rec['collectives']['comm_debug_counts']}); compute s a "
            f"device {t['t_compute_device']:.4f} (global/chips "
            f"{t['t_compute']:.4f}), collective s {t['t_coll']:.4f}, "
            f"{t['dominant']}-bound; {rec['compute_note']}")
    for line in ([] if quiet else R.to_markdown(rows).splitlines()):
        say(f"{label}: {line}")
    return rows


def phase_parallel(device):
    """Phase 14 (its dry-run cells run in the background from phase 3's
    start and are read after phase 15).  Returns the bucket-count launches of
    its main path (the sharded steps and the pipelined stages) and phase
    14a's unsharded run."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    launches, unsharded = phase14_sharded(device)
    launches += phase14_pipeline(device)
    say(f"phase 14: done in {time.perf_counter() - t0:.1f} s (14c's cells "
        f"are read after phase 15); bucket_count launches {launches}")
    return launches, unsharded


# -- phase 15: tensor-parallel compute over "model" -------------------------

TP_WORLD = 2                       # phase 15: ranks of (data 1, model 2)
TP_LOSS_RTOL = 1e-5                # phase 15a: the CPU tests' bounds
TP_PARAM_ATOL = 1e-5               # (tests/test_torch_tp.py)
TP_PREFILL = (2, 2048)             # phase 15b: mamba2, batch x prompt
TP_PREFILL_BOUND = 1e-4            # phase 7's bound, of the largest logit
TP_TIMEOUT_S = 600
TP_DRYRUN_CELLS = (("qwen2-1.5b", "train_4k", False),
                   (MAMBA, "train_4k", False),
                   (PHI, "train_4k", False),
                   ("jamba-1.5-large-398b", "train_4k", False))
DRYRUN_TIMEOUT_S = 700


def _shard_of(x, whole):
    """The slice of ``whole`` (the unsharded leaf) that DTensor ``x``'s
    local shard holds over ``"model"``."""
    names = list(x.device_mesh.mesh_dim_names)
    d = names.index("model")
    pl = x.placements[d]
    if not pl.is_shard():
        return whole
    n = x.to_local().shape[pl.dim]
    return whole.narrow(pl.dim, x.device_mesh.get_local_rank(d) * n, n)


@contextlib.contextmanager
def moe_routes():
    """The experts [T, k] (on the host) each MoE layer's router picks
    under autograd, in call order, while the context is open."""
    import torch
    from repro_torch.moe import moe_layer
    seen, route = [], moe_layer._route

    def recorded(cfg, p, x):
        w, e, probs = route(cfg, p, x)
        if torch.is_grad_enabled():
            seen.append(e.detach().cpu())
        return w, e, probs
    moe_layer._route = recorded
    try:
        yield seen
    finally:
        moe_layer._route = route


@contextlib.contextmanager
def seq_crossings():
    """``{name: calls}`` of the sequence crossings (``gather_seq``,
    ``scatter_seq``, ``split_seq``) while the context is open: the
    sequence-parallel program ran where they are not 0 (gloo on CUDA
    tensors carries them as all-reduces, so the collectives alone do not
    tell)."""
    from repro_torch.runtime import sharding as shd
    names = ("gather_seq", "scatter_seq", "split_seq")
    seen = dict.fromkeys(names, 0)
    orig = {n: getattr(shd, n) for n in names}

    def counted(name):
        def fn(x, shard):
            if shard is not None:
                seen[name] += 1
            return orig[name](x, shard)
        return fn
    for n in names:
        setattr(shd, n, counted(n))
    try:
        yield seen
    finally:
        for n in names:
            setattr(shd, n, orig[n])


def _adamw_leaf(rcfg, p, g, scale, step=0):
    """``p`` after the plain AdamW update of ``make_train_step``'s first
    step on gradient ``g`` clipped by ``scale`` (elementwise, so a shard's
    update is its slice of the whole one)."""
    import torch
    from repro_torch.train.optimizer import adamw
    p = p.clone()
    zeros = {s: {"x": torch.zeros_like(p, dtype=torch.float32)}
             for s in ("m", "v")}
    adamw(rcfg).update({"x": g.float() * scale}, zeros, {"x": p}, step)
    return p


def _phase15a(mesh, device, out_dir, seq_parallel=False):
    """This rank's part of phase 15a (16a with ``seq_parallel``): phi3.5
    at full width (14a's config) on its ``"model"`` shards: the gradients
    of batch 0 against the unsharded ones (in ``out_dir``), then 2
    tensor-parallel (sequence-parallel) AdamW steps against 14a's
    unsharded run."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.coalesce import bucket_count_kernel
    from repro_torch.launch.dryrun import _collective_log_class
    from repro_torch.models import model as M
    from repro_torch.runtime import sharding as shd
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (RULES, make_sharded_grads,
                                              make_sharded_train_step,
                                              sharded_global_norm)
    cfg, rcfg = _phi_train_cfg()
    rcfg = dataclasses.replace(rcfg, seq_parallel=seq_parallel)
    opt = make_optimizer(rcfg)
    model = M.init(cfg, SEED, getattr(torch, rcfg.param_dtype),
                   device=device)
    params = shd.shard_tree(dict(model.named_parameters()), RULES, mesh)
    del model                      # the sharded leaves own their chunks
    torch.cuda.empty_cache()
    stream = TokenStream(cfg, rcfg.shape, seed=0)
    batches = [stream.tensors(i, device=device) for i in range(SHARD_STEPS)]
    out = {}

    # (1) batch 0's gradients against the unsharded ones, leaf by leaf,
    # and the routing; then the first update the step should make of them
    with moe_routes() as routes, seq_crossings() as crossings:
        grads, _, _ = make_sharded_grads(cfg, rcfg, mesh)(params, batches[0])
    out["crossings"] = crossings
    want = torch.load(out_dir / "oracle15a_grads.pt", mmap=True)
    ref = torch.load(out_dir / "oracle15a_ref.pt")
    g_err = g_over = 0
    for k, g in grads.items():
        w = _shard_of(g, want[k]).to(device)
        d = (g.to_local() - w).abs()
        g_err = max(g_err, float(d.max()))
        g_over += int((d > GRAD_ATOL + GRAD_RTOL * w.abs()).sum())
    out["grad_err"], out["grad_over"] = g_err, g_over
    out["route_diff"] = [int((a != b).sum()) for a, b in
                         zip(routes, ref["routes"])]
    gnorm = sharded_global_norm(grads, mesh)
    scale = torch.clamp_max(rcfg.grad_clip / gnorm.clamp_min(1e-12), 1.0)
    p0 = {k: p.to_local().to("cpu", copy=True) for k, p in params.items()}
    expect = {k: _adamw_leaf(rcfg, p0[k].to(device), g.to_local(),
                             scale).cpu() for k, g in grads.items()}
    del grads, want
    torch.cuda.empty_cache()

    # (2) the tensor-parallel step, twice
    opt_state = {s: {k: DTensor.from_local(
        torch.zeros_like(p.to_local(), dtype=torch.float32), mesh,
        p.placements, run_check=False, shape=p.shape, stride=p.stride())
        for k, p in params.items()} for s in ("m", "v")}
    step = make_sharded_train_step(cfg, rcfg, opt, mesh, RULES)
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    torch.cuda.synchronize()
    bucket_count_kernel.launches = 0
    ms, losses, gnorms = [], [], []
    for i, batch in enumerate(batches):
        log = _collective_log_class()()
        with log:
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, i, batch)
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if i == 0:        # the first update: of its own and of the
            #               unsharded gradients
            own = oracle = 0.0
            g_ref = torch.load(out_dir / "oracle15a_grads.pt", mmap=True)
            for k, p in params.items():
                got = p.to_local()
                own = max(own, float((got - expect[k].to(device)).abs()
                                     .max()))
                w = _adamw_leaf(rcfg, p0[k].to(device), _shard_of(
                    p, g_ref[k]).to(device), ref["scale"])
                oracle = max(oracle, float((got - w).abs().max()))
            out["step1_own"], out["step1_oracle"] = own, oracle
            del p0, expect, g_ref
    out["launches"] = bucket_count_kernel.launches
    out["counts"] = {str(k): v for k, v in log.get_comm_counts().items()}
    out["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    want = torch.load(out_dir / "oracle15a.pt", mmap=True)
    err, over, sharded = 0.0, 0, 0
    for k, p in params.items():
        w = _shard_of(p, want[k])
        d = (p.to_local() - w.to(device)).abs()
        err = max(err, float(d.max()))
        over += int((d > TP_PARAM_ATOL).sum())
        sharded += w is not want[k]
    out.update(ms=ms, losses=losses, grad_norms=gnorms, param_err=err,
               param_over=over, sharded=sharded, leaves=len(params),
               elements=sum(p.numel() for p in params.values()))
    return out


def _phase15b(mesh, device, out_dir, seq_parallel=False):
    """This rank's part of phase 15b (16b with ``seq_parallel``):
    mamba2-780m's prefill on its 24 of 48 SSM heads, against the
    one-process prefill (in ``out_dir``)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.runtime import sharding as shd
    from repro_torch.train.train_step import sharded_model
    cfg = ARCHS[MAMBA]
    rcfg = dataclasses.replace(_tp_prefill_rcfg(cfg),
                               seq_parallel=seq_parallel)
    model = M.init(cfg, SEED, device=device)
    params = shd.shard_tree(dict(model.named_parameters()),
                            shd.ShardingRules(shd.SERVE_TP_RULES), mesh)
    del model
    torch.cuda.empty_cache()
    tp, slots = sharded_model(cfg, rcfg)
    shd.bind(slots, params)
    seen = []

    def record(*args):
        seen.append(args[0].shape[0])
        return ssd_chunk_kernel(*args)
    tokens = _tp_prefill_tokens(cfg, device)
    dist.barrier()
    torch.cuda.synchronize()
    ssd_chunk_kernel.launches = 0
    ssm.ssd_chunk_kernel = record
    try:
        with seq_crossings() as crossings:
            (logits, cache), sec = timed(lambda: M.prefill(
                cfg, rcfg, tp, {"tokens": tokens}))
    finally:
        ssm.ssd_chunk_kernel = ssd_chunk_kernel
    launches = ssd_chunk_kernel.launches
    want = torch.load(out_dir / "oracle15b.pt")
    v = cfg.vocab_size
    d_logits = rel_diff(logits[..., :v], want["logits"][..., :v].to(device))
    per = cfg.ssm_heads // mesh.size(1)
    r = mesh.get_local_rank(1)
    d_state = rel_diff(cache[0]["ssm"], want["ssm"][:, :, r * per:(r + 1)
                                                     * per].to(device))
    return {"ms": sec * 1e3, "launches": launches, "grid": seen,
            "heads": per, "logit_err": d_logits, "state_err": d_state,
            "peak": torch.cuda.max_memory_allocated() / 2 ** 30,
            "crossings": crossings}


def _tp_prefill_rcfg(cfg):
    from repro_torch.configs.base import RunConfig, ShapeConfig
    b, s = TP_PREFILL
    return RunConfig(model=cfg, shape=ShapeConfig("prefill", s, b,
                                                  "prefill"),
                     compute_dtype="float32", remat="none", use_pallas=True)


def _tp_prefill_tokens(cfg, device):
    import torch
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    return torch.randint(0, cfg.vocab_size, TP_PREFILL, generator=gen,
                         device=device, dtype=torch.int32)


def _phase15_rank(rank, world, port, out_dir):
    """Gloo rank ``rank`` of phase 15's ``(1, world)`` mesh on ``cuda:0``;
    writes its results to ``out_dir``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out_dir = pathlib.Path(out_dir)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out = {"rank": rank}
    try:
        mesh = make_host_mesh(1, world)
        out["a"] = _phase15a(mesh, device, out_dir)
        torch.cuda.empty_cache()
        out["b"] = _phase15b(mesh, device, out_dir)
    except BaseException as e:   # noqa: BLE001 — reported by the parent
        import traceback
        out["error"] = "".join(traceback.format_exception(e))
    finally:
        dist.destroy_process_group()
    with open(out_dir / f"rank{rank}.json", "w") as fh:
        json.dump(out, fh)


def phase15_oracles(device, unsharded, out_dir):
    """The one-process results phase 15 holds the ranks to, on disk: 14a's
    unsharded parameters after its steps; the unsharded gradients of its
    batch 0 (from the same seed), their clip scale and the routing; and
    mamba2's f32 prefill (logits, SSM states).  Returns the host seconds
    of the saves and the one-process prefill's ms."""
    import torch
    from repro_torch.configs.archs import ARCHS
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import model as M
    from repro_torch.train.train_step import (clip_by_global_norm,
                                              grads_fn)
    t0 = time.perf_counter()
    torch.save(unsharded.pop("params"), out_dir / "oracle15a.pt")
    cfg, rcfg = _phi_train_cfg()
    model = M.init(cfg, SEED, getattr(torch, rcfg.param_dtype),
                   device=device)
    batch = TokenStream(cfg, rcfg.shape, seed=0).tensors(0, device=device)
    with moe_routes() as routes:
        grads, _, _ = grads_fn(cfg, rcfg, model, batch)
    grads = {k: g.detach().cpu() for k, g in grads.items()}
    del model
    torch.cuda.empty_cache()
    torch.save(grads, out_dir / "oracle15a_grads.pt")
    _, gnorm = clip_by_global_norm({k: g.clone() for k, g in grads.items()},
                                   rcfg.grad_clip)
    scale = float(torch.clamp_max(rcfg.grad_clip / gnorm.clamp_min(1e-12),
                                  1.0))
    torch.save({"routes": routes[:cfg.num_layers], "scale": scale,
                "grad_norm": float(gnorm)}, out_dir / "oracle15a_ref.pt")
    del grads
    t_save = time.perf_counter() - t0
    mcfg = ARCHS[MAMBA]
    model = M.init(mcfg, SEED, device=device)
    (logits, cache), sec = timed(lambda: M.prefill(
        mcfg, _tp_prefill_rcfg(mcfg), model,
        {"tokens": _tp_prefill_tokens(mcfg, device)}))
    torch.save({"logits": logits.cpu(), "ssm": cache[0]["ssm"].cpu()},
               out_dir / "oracle15b.pt")
    del model, logits, cache
    torch.cuda.empty_cache()
    return t_save, sec * 1e3


def phase_tensor_parallel(device, unsharded, dryrun):
    """Phase 15: tensor-parallel compute over ``"model"`` on two gloo
    ranks sharing the card ((a) the phi3.5 train step, (b) the mamba2
    prefill), then the dry-run cells of 14c and 15c.  Returns the
    bucket-count and SSD launches of the ranks' main path."""
    import torch
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "phase15"
    out_dir.mkdir(parents=True, exist_ok=True)
    for p in out_dir.glob("rank*.json"):
        p.unlink()
    t_save, ms_one = phase15_oracles(device, unsharded, out_dir)
    port = _free_port()
    t0 = time.perf_counter()
    mpc = mp.get_context("spawn")
    procs = [mpc.Process(target=_phase15_rank,
                         args=(r, TP_WORLD, port, str(out_dir)))
             for r in range(TP_WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(TP_TIMEOUT_S - (time.perf_counter() - t0), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    paths = [out_dir / f"rank{r}.json" for r in range(TP_WORLD)]
    if not all(p.exists() for p in paths):
        raise AssertionError(f"phase 15: a rank wrote no result (exit codes "
                             f"{[p.exitcode for p in procs]})")
    ranks = [json.loads(p.read_text()) for p in paths]
    for r in ranks:
        if "error" in r:
            raise AssertionError(f"phase 15: rank {r['rank']}:\n"
                                 f"{r['error']}")
    from repro_torch.configs.archs import ARCHS
    cfg, rcfg = _phi_train_cfg()
    mamba = ARCHS[MAMBA]
    b, s = TRAIN_BATCH
    moe_layers = sum(sp.mlp == "moe" for sp in cfg.full_pattern) \
        * cfg.num_blocks
    ok = True
    for r in ranks:
        a = r["a"]
        d_loss = max(abs(x - y) / abs(y) for x, y in
                     zip(a["losses"], unsharded["losses"]))
        d_norm = max(abs(x - y) / abs(y) for x, y in
                     zip(a["grad_norms"], unsharded["grad_norms"]))
        say(f"phase 15a: rank {r['rank']}: {PHI} at d_model {cfg.d_model}, "
            f"{cfg.num_layers} layers, f32, remat full, AdamW, {b} x {s} "
            f"tokens on (data 1, model {TP_WORLD}), {a['sharded']} of "
            f"{a['leaves']} leaves split over model: batch 0's gradients vs "
            f"the unsharded ones {a['grad_err']:.3g}, {a['grad_over']} of "
            f"{a['elements']} elements outside rtol {GRAD_RTOL:g} / atol "
            f"{GRAD_ATOL:g}; MoE assignments differing {a['route_diff']}; "
            f"the first step's parameters vs AdamW on its own gradients "
            f"{a['step1_own']:.3g} (bound {TP_PARAM_ATOL:g}), vs AdamW on "
            f"the unsharded gradients {a['step1_oracle']:.3g}; "
            f"{SHARD_STEPS} steps: ms a step "
            f"{', '.join(f'{x:.1f}' for x in a['ms'])} (unsharded, 14a: "
            f"{', '.join(f'{x:.1f}' for x in unsharded['ms'])}); losses "
            f"{', '.join(f'{x:.6f}' for x in a['losses'])} (unsharded "
            f"{', '.join(f'{x:.6f}' for x in unsharded['losses'])}; rel "
            f"{d_loss:.3g}, bound {TP_LOSS_RTOL:g}); grad norms "
            f"{', '.join(f'{x:.6f}' for x in a['grad_norms'])} (rel "
            f"{d_norm:.3g}); parameters after {SHARD_STEPS} steps vs 14a's "
            f"{a['param_err']:.3g}, {a['param_over']} elements over "
            f"{TP_PARAM_ATOL:g}; collectives a step {a['counts']}; peak "
            f"{a['peak']:.2f} GiB (unsharded {unsharded['peak']:.2f}); "
            f"bucket_count launches {a['launches']} (2 x {moe_layers} MoE "
            f"layers x {SHARD_STEPS} steps)")
        ok &= (d_loss <= TP_LOSS_RTOL and d_norm <= TP_LOSS_RTOL
               and a["grad_over"] == 0 and a["step1_own"] <= TP_PARAM_ATOL
               and not any(a["route_diff"]) and a["sharded"] > 0
               and a["launches"] == 2 * moe_layers * SHARD_STEPS)
        bb = r["b"]
        say(f"phase 15b: rank {r['rank']}: {MAMBA} whole, f32, prefill "
            f"{TP_PREFILL[0]} x {TP_PREFILL[1]} on {bb['heads']} of its SSM "
            f"heads: {bb['ms']:.1f} ms (one process {ms_one:.1f}); SSD "
            f"kernel grid G {sorted(set(bb['grid']))} "
            f"({bb['launches']} launches); logits vs the one-process "
            f"prefill {bb['logit_err']:.3g} of the largest (bound "
            f"{TP_PREFILL_BOUND:g}), its SSM states {bb['state_err']:.3g}; "
            f"peak {bb['peak']:.2f} GiB")
        cells = TP_PREFILL[0] * (TP_PREFILL[1] // 128) * bb["heads"]
        ok &= (bb["logit_err"] <= TP_PREFILL_BOUND
               and bb["state_err"] <= TP_PREFILL_BOUND
               and set(bb["grid"]) == {cells}
               and bb["heads"] * TP_WORLD == mamba.ssm_heads
               and bb["launches"] == mamba.num_layers)
    say(f"phase 15: the oracles (14a's parameters, batch 0's unsharded "
        f"gradients) saved in {t_save:.1f} s; "
        f"gloo moves CUDA tensors through host memory, so these times are "
        f"not tensor-parallel times on a fabric; ranks "
        f"{time.perf_counter() - t0:.1f} s with their start")
    if not ok:
        raise AssertionError("phase 15: tensor-parallel vs one process")
    procs, out = dryrun
    finish_dryrun(procs, DRYRUN_TIMEOUT_S)
    rows14 = dryrun_rows("phase 14c", DRYRUN_CELLS, out)
    rows15 = dryrun_rows("phase 15c", TP_DRYRUN_CELLS, out)
    if len(rows14) != len(DRYRUN_CELLS) or len(rows15) != len(
            TP_DRYRUN_CELLS):
        raise AssertionError("phase 14c/15c: a dry-run record is missing")
    launches = {"bucket_count": sum(r["a"]["launches"] for r in ranks),
                "ssd_chunk": sum(r["b"]["launches"] for r in ranks)}
    say(f"phase 15: done in {time.perf_counter() - t_phase:.1f} s; "
        f"launches {launches}")
    return launches


# -- phase 16: the sequence over "model" -----------------------------------

SP_DECODE = (2, 2048, 16)          # phase 16c: qwen2, batch x prompt + new
SP_DRYRUN_CELLS = TP_DRYRUN_CELLS  # phase 16d: with --seq-parallel
SP_TAG = "__sp"                    # their records' suffix
SP_TIMEOUT_S = 600


def _sp_decode_tokens(cfg, device):
    import torch
    b, s, _ = SP_DECODE
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=device, dtype=torch.int32)


def _phase16c(mesh, device, out_dir):
    """This rank's part of phase 16c: qwen2-1.5b whole, bf16, on its
    ``SERVE_TP_RULES`` shards: a tensor-parallel prefill, the cache placed
    on ``cache_seq`` (this rank's W/2 slots of both kv heads), 16 greedy
    tokens; then the decode alone, timed."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import model as M
    from repro_torch.runtime import sharding as shd
    from repro_torch.serve.serve_step import generate, sample
    from repro_torch.train.train_step import sharded_model
    b, s, new = SP_DECODE
    cfg, rcfg, model = _lm(QWEN, device, seq=s + new, batch=b)
    params = shd.shard_tree(dict(model.named_parameters()),
                            shd.ShardingRules(shd.SERVE_TP_RULES), mesh)
    del model
    torch.cuda.empty_cache()
    tp, slots = sharded_model(cfg, rcfg)
    shd.bind(slots, params)
    tokens = _sp_decode_tokens(cfg, device)
    dist.barrier()
    toks, gen_s = timed(lambda: generate(cfg, rcfg, tp, {"tokens": tokens},
                                         max_new_tokens=new, device=device))
    logits, cache = M.prefill(cfg, rcfg, tp, {"tokens": tokens},
                              max_len=s + new)
    k = cache[0]["k"]
    cache_gib = sum(x.numel() * x.element_size() for _, x in
                    shd.tree_items(cache)) / 2 ** 30
    tok = sample(logits)
    dist.barrier()

    def decode():
        c, t = cache, tok
        for i in range(new):
            lg, c = M.decode_step(cfg, rcfg, tp, c, t, s + i)
            t = sample(lg)
    dec_ms = wall_s(decode) / new * 1e3
    want = torch.load(out_dir / "oracle16c.pt")["tokens"]
    same = toks.cpu() == want
    return {"tokens": toks.cpu().tolist(), "equal": bool(same.all()),
            "first_diff": [int((~r).nonzero()[0]) if not r.all() else -1
                           for r in same],
            "gen_s": gen_s, "decode_ms": dec_ms, "cache_gib": cache_gib,
            "k_shape": list(k.shape), "w": int(cache[0]["pos"].shape[-1]),
            "peak": torch.cuda.max_memory_allocated() / 2 ** 30}


def _phase16_rank(rank, world, port, out_dir):
    """Gloo rank ``rank`` of phase 16's ``(1, world)`` mesh on ``cuda:0``;
    reads phase 15's oracles and writes its results to ``out_dir``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out_dir = pathlib.Path(out_dir)
    oracles = ROOT / "build" / "phase15"
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out = {"rank": rank}
    try:
        mesh = make_host_mesh(1, world)
        torch.cuda.reset_peak_memory_stats()
        out["a"] = _phase15a(mesh, device, oracles, seq_parallel=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out["b"] = _phase15b(mesh, device, oracles, seq_parallel=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out["c"] = _phase16c(mesh, device, out_dir)
    except BaseException as e:   # noqa: BLE001 — reported by the parent
        import traceback
        out["error"] = "".join(traceback.format_exception(e))
    finally:
        dist.destroy_process_group()
    with open(out_dir / f"rank{rank}.json", "w") as fh:
        json.dump(out, fh)


def phase16_oracles(device, out_dir):
    """16c's one-process ``generate()`` (qwen2 whole, bf16) on disk, with
    its seconds and, per generated token, the gap between the two largest
    logits of its step (how near a tie each greedy choice was)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve.serve_step import generate
    b, s, new = SP_DECODE
    cfg, rcfg, model = _lm(QWEN, device, seq=s + new, batch=b)
    tokens = _sp_decode_tokens(cfg, device)
    toks, sec = timed(lambda: generate(cfg, rcfg, model, {"tokens": tokens},
                                       max_new_tokens=new, device=device))
    gaps = []
    with torch.no_grad():
        logits, cache = M.prefill(cfg, rcfg, model, {"tokens": tokens},
                                  max_len=s + new)
        for i in range(new):
            top = logits[:, 0, :cfg.vocab_size].float().topk(2).values
            gaps.append((top[:, 0] - top[:, 1]).tolist())
            if i + 1 < new:
                logits, cache = M.decode_step(cfg, rcfg, model, cache,
                                              toks[:, i:i + 1], s + i)
    torch.save({"tokens": toks.cpu(), "gaps": gaps}, out_dir /
               "oracle16c.pt")
    del model, cache, logits
    torch.cuda.empty_cache()
    return sec, gaps


def phase_sequence_parallel(device, dryrun):
    """Phase 16: the sequence over ``"model"`` on two gloo ranks sharing
    the card ((a) the phi3.5 step, (b) the mamba2 prefill, (c) qwen2's
    decode on a ``cache_seq``-split cache), then the dry-run cells of
    16d.  Returns the bucket-count and SSD launches of the ranks' main
    path."""
    import torch
    import torch.multiprocessing as mp
    from repro_torch.configs.archs import ARCHS
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / "phase16"
    out_dir.mkdir(parents=True, exist_ok=True)
    for p in out_dir.glob("rank*.json"):
        p.unlink()
    one_s, gaps = phase16_oracles(device, out_dir)
    port = _free_port()
    t0 = time.perf_counter()
    mpc = mp.get_context("spawn")
    procs = [mpc.Process(target=_phase16_rank,
                         args=(r, TP_WORLD, port, str(out_dir)))
             for r in range(TP_WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(SP_TIMEOUT_S - (time.perf_counter() - t0), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    t_ranks = time.perf_counter() - t0
    paths = [out_dir / f"rank{r}.json" for r in range(TP_WORLD)]
    if not all(p.exists() for p in paths):
        raise AssertionError(f"phase 16: a rank wrote no result (exit codes "
                             f"{[p.exitcode for p in procs]})")
    ranks = [json.loads(p.read_text()) for p in paths]
    for r in ranks:
        if "error" in r:
            raise AssertionError(f"phase 16: rank {r['rank']}:\n"
                                 f"{r['error']}")
    cfg, _ = _phi_train_cfg()
    mamba, qwen = ARCHS[MAMBA], ARCHS[QWEN]
    b, s = TRAIN_BATCH
    moe_layers = sum(sp.mlp == "moe" for sp in cfg.full_pattern) \
        * cfg.num_blocks
    ok = True
    for r in ranks:
        a, bb, c = r["a"], r["b"], r["c"]
        say(f"phase 16a: rank {r['rank']}: {PHI} at d_model {cfg.d_model}, "
            f"{cfg.num_layers} layers, f32, remat full, AdamW, {b} x {s} "
            f"tokens, seq_parallel on (data 1, model {TP_WORLD}): "
            f"{s // TP_WORLD} positions a rank between layers; sequence "
            f"crossings in batch 0's gradients {a['crossings']}; its "
            f"gradients vs the unsharded ones {a['grad_err']:.3g}, "
            f"{a['grad_over']} of {a['elements']} elements outside rtol "
            f"{GRAD_RTOL:g} / atol {GRAD_ATOL:g}; MoE assignments differing "
            f"{a['route_diff']}; the first step's parameters vs AdamW on "
            f"its own gradients {a['step1_own']:.3g} (bound "
            f"{TP_PARAM_ATOL:g}), vs AdamW on the unsharded gradients "
            f"{a['step1_oracle']:.3g}; {SHARD_STEPS} steps: ms a step "
            f"{', '.join(f'{x:.1f}' for x in a['ms'])}; losses "
            f"{', '.join(f'{x:.6f}' for x in a['losses'])}; grad norms "
            f"{', '.join(f'{x:.6f}' for x in a['grad_norms'])}; parameters "
            f"after {SHARD_STEPS} steps vs 14a's {a['param_err']:.3g}; "
            f"collectives a step {a['counts']}; peak {a['peak']:.2f} GiB "
            f"a rank; bucket_count launches {a['launches']} (2 x "
            f"{moe_layers} MoE layers x {SHARD_STEPS} steps)")
        ok &= (a["grad_over"] == 0 and a["step1_own"] <= TP_PARAM_ATOL
               and not any(a["route_diff"]) and a["sharded"] > 0
               and a["crossings"]["scatter_seq"] > 0
               and all(math.isfinite(x) for x in a["losses"])
               and a["launches"] == 2 * moe_layers * SHARD_STEPS)
        say(f"phase 16b: rank {r['rank']}: {MAMBA} whole, f32, "
            f"sequence-parallel prefill {TP_PREFILL[0]} x {TP_PREFILL[1]} "
            f"({TP_PREFILL[1] // TP_WORLD} positions a rank between "
            f"layers, {bb['heads']} SSM heads over the whole sequence; "
            f"crossings {bb['crossings']}): {bb['ms']:.1f} ms; SSD kernel "
            f"grid G {sorted(set(bb['grid']))} ({bb['launches']} launches); "
            f"logits vs the one-process prefill {bb['logit_err']:.3g} of "
            f"the largest (bound {TP_PREFILL_BOUND:g}), its SSM states "
            f"{bb['state_err']:.3g}; peak {bb['peak']:.2f} GiB")
        cells = TP_PREFILL[0] * (TP_PREFILL[1] // 128) * bb["heads"]
        ok &= (bb["logit_err"] <= TP_PREFILL_BOUND
               and bb["crossings"]["scatter_seq"] > 0
               and set(bb["grid"]) == {cells}
               and bb["launches"] == mamba.num_layers)
        db, ds, dn = SP_DECODE
        say(f"phase 16c: rank {r['rank']}: {QWEN} whole, bf16, "
            f"tensor-parallel prefill {db} x {ds} + {dn} greedy tokens on "
            f"a cache split on cache_seq: layer 0's k {c['k_shape']} of W "
            f"{c['w']} (kv heads {qwen.num_kv_heads}); cache "
            f"{c['cache_gib']:.3f} GiB a rank; generate() {c['gen_s']:.2f} "
            f"s (one process {one_s:.2f}); decode {c['decode_ms']:.2f} "
            f"ms/token; tokens equal the one-process generate()'s: "
            f"{c['equal']} (first difference per row {c['first_diff']}); "
            f"peak {c['peak']:.2f} GiB")
        ok &= (c["equal"] and c["k_shape"][2] * TP_WORLD == c["w"]
               and c["k_shape"][3] == qwen.num_kv_heads)
    say(f"phase 16c: the one-process run's top-2 logit gaps per token "
        f"(smallest per step) {[round(min(g), 4) for g in gaps]}; "
        f"gloo moves CUDA tensors through host memory, so these times are "
        f"not sequence-parallel times on a fabric; ranks {t_ranks:.1f} s "
        f"with their start")
    if not ok:
        raise AssertionError("phase 16: the sequence over model vs one "
                             "process")
    procs, out = dryrun
    finish_dryrun(procs, DRYRUN_TIMEOUT_S)
    rows = dryrun_rows("phase 16d", SP_DRYRUN_CELLS, out, SP_TAG)
    tp = {(r["arch"], r["shape"]): r for r in dryrun_rows(
        "phase 16d (15c, for comparison)", SP_DRYRUN_CELLS, out, quiet=True)}
    from repro_torch.launch import roofline as R
    for rec in rows:
        base = tp[(rec["arch"], rec["shape"])]
        t_sp, t_tp = R.terms(rec), R.terms(base)

        def wire(r, kind):
            return r["collectives"]["per_op"][kind]["wire_bytes"] / 1e9
        say(f"phase 16d: {rec['arch']} x {rec['shape']}: collective s "
            f"{t_sp['t_coll']:.4f} with --seq-parallel, "
            f"{t_tp['t_coll']:.4f} without; compute s a device "
            f"{t_sp['t_compute_device']:.4f} / "
            f"{t_tp['t_compute_device']:.4f}; wire GB a device: all-reduce "
            f"{wire(rec, 'all-reduce'):.3f} / {wire(base, 'all-reduce'):.3f}"
            f", all-gather {wire(rec, 'all-gather'):.3f} / "
            f"{wire(base, 'all-gather'):.3f}, reduce-scatter "
            f"{wire(rec, 'reduce-scatter'):.3f} / "
            f"{wire(base, 'reduce-scatter'):.3f}")
    dec = dryrun_rows("phase 16d", [c for c in DRYRUN_CELLS
                                    if c[1] == "decode_32k"], out)
    if len(rows) != len(SP_DRYRUN_CELLS) or not dec:
        raise AssertionError("phase 16d: a dry-run record is missing")
    launches = {"bucket_count": sum(r["a"]["launches"] for r in ranks),
                "ssd_chunk": sum(r["b"]["launches"] for r in ranks)}
    say(f"phase 16: done in {time.perf_counter() - t_phase:.1f} s "
        f"(ranks {t_ranks:.1f} s); launches {launches}")
    return launches


DIST_WORLD = 8                     # phase 17b-c: gloo ranks sharing cuda:0
DIST_MAX_SUBROUNDS = 256           # phase 17b-c: a wave's sub-round cap
REQUEUE_CAPACITY = 2 ** 14         # phase 17b: BFS with sub-round requeue
TENANT_CAPACITY = 2 ** 15          # phase 17b-c: C on the scale-16 tenant
DIST_TIMEOUT_S = 600
EXAMPLE_TIMEOUT_S = 300
TRAIN_RESUME_STEPS = 310           # phase 17a: train_lm's second run


def phase17_inputs(g, single, device):
    """What phase 17b's ranks read, saved to ``build/phase17/`` while
    phase 4's graph is on the card: the scale-21 graph with both weight
    arrays and phase 4's ``pallas`` answers; the scale-16 tenant (phase
    5's graph, phase 8d's tenant 0) with phase 8's single-shard answers
    on it, computed here as phase 8 computes them.  Returns the
    directory and the host seconds of the saves."""
    import torch
    from repro_torch.core.commit import CommitSpec
    from repro_torch.graphs.algorithms.bfs import bfs
    from repro_torch.graphs.algorithms.boruvka import boruvka
    from repro_torch.graphs.algorithms.coloring import coloring
    from repro_torch.graphs.algorithms.stconn import st_connectivity
    from repro_torch.graphs.generators import kronecker, random_weights
    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "phase17"
    out_dir.mkdir(parents=True, exist_ok=True)
    bfs0, sssp0, ranks0 = single

    def host(graph):
        return {"indptr": graph.indptr.cpu(), "src": graph.src.cpu(),
                "dst": graph.dst.cpu(), "weights": graph.weights.cpu(),
                "num_vertices": graph.num_vertices,
                "num_edges": graph.num_edges}
    gw = random_weights(g, seed=0)
    torch.save({"graph": host(g), "sssp_weights": gw.weights.cpu(),
                "source": int(torch.argmax(g.degrees)),
                "bfs": bfs0.dist.cpu(), "sssp": sssp0.cpu(),
                "ranks": ranks0.cpu()}, out_dir / "scale21.pt")
    del gw
    t = kronecker(16, 16, seed=SEED, device=device)
    tw = random_weights(t, seed=0)
    spec = CommitSpec(backend="pallas", stats=False)
    src = int(torch.argmax(t.degrees))
    dist = bfs(t, src, spec=spec).dist
    far, lone = far_and_lone(dist)
    color, rc, nc = coloring(t, seed=0, spec=spec)
    comp, w, ne, rb = boruvka(tw, spec=spec)
    torch.save({"graph": host(t), "mst_weights": tw.weights.cpu(),
                "source": src, "far": far, "lone": lone, "bfs": dist.cpu(),
                "stconn": {far: bool(st_connectivity(t, src, far,
                                                     spec=spec)[0]),
                           lone: bool(st_connectivity(t, src, lone,
                                                      spec=spec)[0])},
                "coloring": (color.cpu(), rc, bool(nc)),
                "boruvka": (comp.cpu(), w.cpu(), int(ne), rb)},
               out_dir / "tenant.pt")
    return out_dir, time.perf_counter() - t0


def _run_examples(runs, cwd, env):
    """Each run of ``runs`` (argv lists of ``examples_torch/``) one after
    another in ``cwd``: (label, completed process, host s) each."""
    out = []
    cwd.mkdir(parents=True, exist_ok=True)
    for argv in runs:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples_torch" / f"{argv[0]}.py"),
             *argv[1:]], cwd=cwd, env=env, capture_output=True, text=True,
            timeout=EXAMPLE_TIMEOUT_S)
        label = " ".join(a for a in argv if not a.startswith("/"))
        out.append((label, proc, time.perf_counter() - t0))
    return out


def phase17_examples():
    """Phase 17a: the five examples of ``examples_torch/``, each a
    subprocess on the card (their default device) in its own directory
    under ``chiprun_out/phase17a`` (its tuner cache and trace there), the
    five at once; ``train_lm`` twice on one checkpoint directory, the
    second run resuming from the first's last checkpoint.  Their own
    asserts are the check; their lines are echoed.  Returns each run's
    host seconds (with the others running beside it)."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    base = ROOT / "chiprun_out" / "phase17a"
    ckpt = ROOT / "build" / "phase17" / "ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    groups = [[("quickstart",)], [("graph_analytics", "--distributed")],
              [("distributed_pagerank",)], [("serve_queries",)],
              [("train_lm", "--ckpt-dir", str(ckpt)),
               ("train_lm", "--ckpt-dir", str(ckpt), "--steps",
                str(TRAIN_RESUME_STEPS))]]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with ThreadPoolExecutor(len(groups)) as pool:
        done = list(pool.map(lambda grp: _run_examples(
            grp, base / grp[0][0], env), groups))
    secs, outs = {}, {}
    for label, proc, sec in (run for grp in done for run in grp):
        secs[label] = sec
        for line in proc.stdout.splitlines():
            if line.strip():
                say(f"phase 17a: {label.split()[0]}: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"phase 17a: examples_torch/{label} exited "
                                 f"{proc.returncode}:\n"
                                 f"{proc.stderr[-6000:]}")
        outs[label] = proc.stdout
    first, second = list(outs.values())[-2:]
    if "[launch] done: 300 steps" not in first or \
            "[launch] resumed from step 300" not in second:
        raise AssertionError("phase 17a: train_lm did not train 300 steps "
                             "and resume from step 300")
    return secs


def _phase17_rank(mesh, out_dir):
    """Rank ``mesh.rank`` of phases 17b and 17c; writes its launches and
    peaks (rank 0 also its results) to ``out_dir/rank<r>.json``."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.core.commit import CommitSpec
    from repro_torch.graphs.algorithms.bfs import distributed_bfs
    from repro_torch.graphs.algorithms.boruvka import distributed_boruvka
    from repro_torch.graphs.algorithms.coloring import distributed_coloring
    from repro_torch.graphs.algorithms.pagerank import distributed_pagerank
    from repro_torch.graphs.algorithms.sssp import distributed_sssp
    from repro_torch.graphs.algorithms.stconn import distributed_stconn
    from repro_torch.graphs.csr import Graph
    out_dir = pathlib.Path(out_dir)
    dev = mesh.device

    def on_card(h):
        return Graph(indptr=h["indptr"].to(dev), src=h["src"].to(dev),
                     dst=h["dst"].to(dev), weights=h["weights"].to(dev),
                     num_vertices=h["num_vertices"],
                     num_edges=h["num_edges"])
    big = torch.load(out_dir / "scale21.pt")
    g = on_card(big["graph"])
    gw = dataclasses.replace(g, weights=big["sssp_weights"].to(dev))
    ten = torch.load(out_dir / "tenant.pt")
    t = on_card(ten["graph"])
    tw = dataclasses.replace(t, weights=ten["mst_weights"].to(dev))
    src, tsrc = big["source"], ten["source"]
    fused = CommitSpec(backend="fused", stats=False)
    pallas = CommitSpec(backend="pallas", stats=False)
    counted = CommitSpec(backend="pallas")      # stats: conflicts counted
    v = g.num_vertices

    def ranks_err(got):
        exp = big["ranks"].to(dev)
        torch.testing.assert_close(
            got * v, exp * v, rtol=ADD_RTOL, atol=ADD_ATOL,
            msg=lambda m: f"phase 17b distributed_pagerank: {m}")
        return float(((got - exp).abs() / exp.abs()).max())

    def same(a, b):
        try:
            equal("", a, b)
        except AssertionError:
            return False
        return True
    kw = dict(max_subrounds=DIST_MAX_SUBROUNDS, telemetry=True)
    drop = dict(snapshot_rounds=2, fault_injector=_drop_at_chunk_1)
    runs = [
        # (name, graph, the run, its check on rank 0)
        ("bfs C=auto", "21", lambda: distributed_bfs(
            mesh, g, src, capacity="auto", spec=fused, **kw),
         lambda o: same(o[0], big["bfs"])),
        (f"bfs C=2^{REQUEUE_CAPACITY.bit_length() - 1}", "21",
         lambda: distributed_bfs(mesh, g, src, capacity=REQUEUE_CAPACITY,
                                 spec=fused, **kw),
         lambda o: same(o[0], big["bfs"])),
        ("sssp C=auto", "21", lambda: distributed_sssp(
            mesh, gw, src, capacity="auto", spec=fused, **kw),
         lambda o: same(o[0], big["sssp"])),
        ("pagerank C=auto", "21", lambda: distributed_pagerank(
            mesh, g, iters=20, capacity="auto", spec=fused, **kw),
         lambda o: ranks_err(o[0])),
        ("bfs", "16", lambda: distributed_bfs(
            mesh, t, tsrc, capacity=TENANT_CAPACITY, spec=counted, **kw),
         lambda o: same(o[0], ten["bfs"])),
        ("stconn reached", "16", lambda: distributed_stconn(
            mesh, t, tsrc, ten["far"], capacity=TENANT_CAPACITY,
            spec=pallas, **kw),
         lambda o: bool(o[0]) == ten["stconn"][ten["far"]]),
        ("stconn unreached", "16", lambda: distributed_stconn(
            mesh, t, tsrc, ten["lone"], capacity=TENANT_CAPACITY,
            spec=pallas, **kw),
         lambda o: bool(o[0]) == ten["stconn"][ten["lone"]]),
        ("coloring", "16", lambda: distributed_coloring(
            mesh, t, seed=0, capacity=TENANT_CAPACITY, spec=pallas, **kw),
         lambda o: same((o[0], o[1], bool(o[2])), ten["coloring"])),
        ("boruvka", "16", lambda: distributed_boruvka(
            mesh, tw, capacity=TENANT_CAPACITY, spec=pallas, **kw),
         lambda o: same((o[0], o[1], int(o[2]), o[3]), ten["boruvka"])),
        # 17c: a fault before chunk 1 on every rank: 8 -> 7 shards
        ("degraded bfs", "16", lambda: distributed_bfs(
            mesh, t, tsrc, capacity=TENANT_CAPACITY, spec=pallas, **kw,
            **drop),
         lambda o: same(o[0], ten["bfs"])),
        ("degraded boruvka", "16", lambda: distributed_boruvka(
            mesh, tw, capacity=TENANT_CAPACITY, spec=pallas, **kw, **drop),
         lambda o: same((o[0], o[1], int(o[2]), o[3]), ten["boruvka"])),
    ]
    # a fresh rank's first waves pay seconds of first use (the first
    # collectives of CUDA tensors, allocations, the kernels' loads): a
    # BFS on the tenant on each tier first, its time kept apart
    first = {}
    for spec in (fused, pallas):
        dist.barrier()
        first[spec.backend] = timed(lambda: distributed_bfs(
            mesh, t, tsrc, capacity=TENANT_CAPACITY, spec=spec))[1] * 1e3
    # the set-up every call repeats before its first round (the edge
    # partition, the slices, the state), as phase 6 takes it: a
    # 0-iteration distributed_pagerank, its second call
    setup = {}
    for graph, gg, spec in (("21", g, fused), ("16", t, pallas)):
        for _ in range(2):
            dist.barrier()
            setup[graph] = timed(lambda: distributed_pagerank(
                mesh, gg, iters=0, capacity="auto", spec=spec))[1]
    out = {"rank": mesh.rank, "runs": {}, "first_ms": first,
           "setup_ms": {k: v * 1e3 for k, v in setup.items()}}
    clean = {}
    kernels = graph_kernels()
    for k in kernels.values():
        k.launches = 0
    for name, graph, run, check in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        (*got, res), wall = timed(run)
        rec = {"graph": graph, "rounds": res.rounds,
               "subrounds": res.subrounds,
               "conflicts": int(res.conflicts) if name == "bfs" else None,
               "delivered_all": bool(res.delivered_all),
               "capacity": res.capacity, "shards": res.shards,
               "degraded": bool(res.degraded), "call_ms": wall * 1e3,
               "ms_round": (wall - setup[graph]) / max(res.rounds, 1)
               * 1e3,
               "peak": torch.cuda.max_memory_allocated() / 2 ** 30}
        if mesh.rank == 0:
            rec["check"] = check(got)
            base = name.replace("degraded ", "")
            if name.startswith("degraded "):
                rec["equals_clean"] = same(tuple(got), clean[base])
            else:
                clean[name] = tuple(got)
        out["runs"][name] = rec
    out["launches"] = {name: k.launches for name, k in kernels.items()}
    with open(out_dir / f"rank{mesh.rank}.json", "w") as fh:
        json.dump(out, fh)


def phase_distributed(device, inputs, engine_ms):
    """Phase 17: (a) the examples on the card; (b) ``run_distributed``'s
    six algorithms at world size 8 on gloo ranks sharing ``cuda:0``, on
    phase 4's scale-21 graph and phase 8's scale-16 tenant, held to the
    single-shard answers; (c) degraded-mesh runs that shrink 8 -> 7.
    Returns the graph kernels' launches of the ranks' main path."""
    import torch
    from repro_torch.launch.mesh import spawn_ranks
    t_phase = time.perf_counter()
    out_dir, t_save = inputs
    secs = phase17_examples()
    say(f"phase 17a: the five examples exit 0 on the card; host s "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    torch.cuda.empty_cache()
    for p in out_dir.glob("rank*.json"):
        p.unlink()
    t0 = time.perf_counter()
    spawn_ranks(_phase17_rank, DIST_WORLD, device=device,
                args=(str(out_dir),), timeout_s=DIST_TIMEOUT_S)
    t_ranks = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(DIST_WORLD)]
    zero = ranks[0]["runs"]
    say(f"phase 17b: rank 0's first calls (a BFS on the scale-16 tenant): "
        f"fused {ranks[0]['first_ms']['fused']:.1f} ms, then pallas "
        f"{ranks[0]['first_ms']['pallas']:.1f} ms; set-up of a call (a "
        f"0-iteration distributed_pagerank): scale 21 "
        f"{ranks[0]['setup_ms']['21']:.1f} ms, scale 16 "
        f"{ranks[0]['setup_ms']['16']:.1f} ms; ms/round below = (call - "
        f"set-up) / rounds, host clock around synchronised work")
    ok = True
    for name, rec in zero.items():
        part = "17c" if name.startswith("degraded") else "17b"
        peaks = [r["runs"][name]["peak"] for r in ranks]
        at1 = ""
        algo = name.split()[0]
        if rec["graph"] == "21" and algo in engine_ms["fused"]:
            ms1, sub1 = engine_ms["fused"][algo]
            at1 = (f"; phase 6 (world size 1, fused, C = 2^24): "
                   f"{ms1:.2f} ms/round, {sub1:.2f} sub-rounds/round")
        check = rec["check"]
        check = (f"within rtol {ADD_RTOL:g} / atol {ADD_ATOL:g} of phase "
                 f"4's ranks (largest relative difference {check:.3g})"
                 if isinstance(check, float) else
                 f"equals the single-shard answer: {check}")
        say(f"phase {part}: scale {rec['graph']} {name:18s} "
            f"{rec['rounds']} rounds, {rec['ms_round']:.2f} ms/round "
            f"(call {rec['call_ms']:.1f} ms; gloo host staging, not a "
            f"fabric), {rec['subrounds']} sub-rounds, "
            + (f"conflicts {rec['conflicts']} (stats=True)"
               if rec["conflicts"] is not None else
               "conflicts not counted (stats=False)")
            + f", C {rec['capacity']}, shards "
            f"{rec['shards']}, degraded={rec['degraded']}, "
            f"delivered_all={rec['delivered_all']}, {check}"
            + (f", equals the clean 8-rank run: {rec['equals_clean']}"
               if "equals_clean" in rec else "")
            + f"; peak GiB a rank {[round(x, 2) for x in peaks]}{at1}")
        ok &= rec["delivered_all"] and rec["check"] is not False
        if part == "17c":
            ok &= (rec["shards"] == DIST_WORLD - 1 and rec["degraded"]
                   and rec["equals_clean"])
        else:
            ok &= rec["shards"] == DIST_WORLD and not rec["degraded"]
    requeue = zero[f"bfs C=2^{REQUEUE_CAPACITY.bit_length() - 1}"]
    if requeue["subrounds"] <= requeue["rounds"]:
        raise AssertionError("phase 17b: the small-capacity BFS did not "
                             "requeue (sub-rounds <= rounds)")
    launches = {name: sum(r["launches"][name] for r in ranks)
                for name in ranks[0]["launches"]}
    say(f"phase 17b-c: {DIST_WORLD} gloo ranks on {device} (spawned, "
        f"kernels built in the parent), {t_ranks:.1f} s with their start; "
        f"inputs saved in {t_save:.1f} s; launches {launches}")
    if not ok:
        raise AssertionError("phase 17b-c: the engine at world size "
                             f"{DIST_WORLD} vs the single-shard answers")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"phase 17: {name} was not launched")
    say(f"phase 17: done in {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    device = torch.device("cuda")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    say(smi.stdout.strip().splitlines()[0])
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    reports = _build.build()
    regs = [line.strip() for log in reports.values()
            for line in log.splitlines() if "spill" in line and
            not line.strip().endswith("0 bytes spill loads")]
    say(f"phase 2: built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s; ptxas spill lines with loads: "
        f"{len(regs)}")
    # the dry-run cells of 14c, 15c and 16d, on the cores the phases leave
    # idle
    out = ROOT / "build" / "phase14_dryrun"
    dryrun = start_dryrun(dryrun_cells(), out)
    try:
        return _phases(device, dryrun, out)
    finally:
        stop_dryrun(dryrun)


def dryrun_cells() -> list:
    """The dry-run cells of 14c, 15c and 16d (these with
    ``--seq-parallel``), one process each."""
    sp = ("--seq-parallel", "--tag", SP_TAG)
    return sorted(set(DRYRUN_CELLS + TP_DRYRUN_CELLS)) + [
        cell + (sp,) for cell in SP_DRYRUN_CELLS]


def _phases(device, dryrun, out) -> int:
    """Phases 3 to 17 and the last two lines, beside the dry-run cells of
    14c, 15c and 16d in the background."""
    import torch
    from repro_torch.graphs.algorithms.bfs import bfs, bfs_reference
    from repro_torch.graphs.algorithms.pagerank import (pagerank,
                                                         pagerank_reference)
    from repro_torch.graphs.generators import kronecker
    from repro_torch.core.commit import CommitSpec

    # phase 3's kernels; phase 7 adds the SSD chunk's
    max_err = dict.fromkeys(("coarse_commit", "fused_route_commit",
                             "bucket_count"), 0.0)
    phase_kernel_grid(device, max_err)
    phase_count_grid(device, max_err)

    t0 = time.perf_counter()
    g = kronecker(SCALE, 16, seed=SEED, device=device)
    say(f"graph: Kronecker scale {SCALE} ef 16 seed {SEED}: "
        f"V={g.num_vertices} E={g.num_edges} built on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    times = phase_kernel_times(g, device, max_err)
    times["bucket_count"] = phase_count_times(g, device)
    launches, single, round_ms = phase_main_path(g, device)

    small = kronecker(16, 16, seed=SEED, device=device)
    src = int(torch.argmax(small.degrees))
    pr_ref = torch.from_numpy(pagerank_reference(small)) * small.num_vertices
    for backend in ("pallas", "fused"):
        spec = CommitSpec(backend=backend, stats=False)
        r = bfs(small, src, spec=spec)
        if not (r.dist.cpu().numpy() == bfs_reference(small, src)).all():
            raise AssertionError(f"bfs({backend}) != bfs_reference")
        pr, _ = pagerank(small, iters=20, spec=spec)
        torch.testing.assert_close(
            pr.cpu().double() * small.num_vertices, pr_ref, rtol=ADD_RTOL,
            atol=ADD_ATOL, msg=lambda m: f"pagerank({backend}) x V: {m}")
    say("phase 5: on scale 16 (pallas, fused), bfs equals bfs_reference "
        "and pagerank x V agrees with pagerank_reference (float64)")

    engine_launches, engine_ms = phase_engine(g, device, single)
    slice_launches, slice_one, batch = phase_graph_slice(g, small, device,
                                                         single)
    tuned_launches = phase_tuned(g, device, single, slice_one)
    serve_launches = phase_serving(g, device, single, slice_one, batch)
    rounds13 = phase13_rounds(g, device, round_ms)
    inputs17 = phase17_inputs(g, single, device)
    del g, single, small, slice_one, batch
    mamba_launches, times["ssd_chunk"] = phase_mamba2(device, max_err)
    torch.cuda.empty_cache()
    costs13 = {}
    lm_launches = phase_lm_families(device, costs13)
    torch.cuda.empty_cache()
    train_launches = phase_training(device)
    analysis_launches = phase_analysis(device, rounds13, costs13)
    torch.cuda.empty_cache()
    parallel_launches, unsharded = phase_parallel(device)
    tp_launches = phase_tensor_parallel(device, unsharded, (dryrun, out))
    sp_launches = phase_sequence_parallel(device, (dryrun, out))
    dist_launches = phase_distributed(device, inputs17, engine_ms)
    mamba_launches += tp_launches["ssd_chunk"] + sp_launches["ssd_chunk"]
    parallel_launches += tp_launches["bucket_count"] + \
        sp_launches["bucket_count"]
    launches = {name: sum(part.get(name, 0) for part in (
        launches, engine_launches, slice_launches, tuned_launches,
        serve_launches, dist_launches)) for name in KERNELS}
    launches["ssd_chunk"] = mamba_launches
    launches["bucket_count"] += lm_launches + train_launches + \
        parallel_launches
    launches = {name: n + analysis_launches[name]
                for name, n in launches.items()}

    kernels = [dict(name=name, route="cuda", source=src_path,
                    replaces=replaces, launches=launches[name],
                    max_abs_err=max_err[name], ms=times[name]["ms"],
                    call_ms=times[name]["call_ms"],
                    plain_ms=times[name]["plain_ms"],
                    bound_ms=times[name]["bound_ms"],
                    bound_by=times[name]["bound_by"],
                    library_ms=times[name]["library_ms"])
               for name, (src_path, replaces) in KERNELS.items()]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
