"""The port's CUDA kernels against their plain versions, the wave engine
and the graph service on the card against the CPU, the Mamba2 serving
path on its kernel path against its plain path, every LM family at smoke
width on the card against the CPU (f32 logits within 1e-4 of the
largest; the MoE plans' bucket counts bit for bit), and f32 train steps
of each trained family on the card against the CPU (losses rtol 1e-5,
gradients rtol 1e-4 / atol 1e-6, an update from the same gradients atol
1e-6; every train-time plan, remat's recompute's too, equal to
``torch.bincount``'s).

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: bit-identical state, conflict count and bucket counts; float
``add`` within rtol 2e-4 / atol 1e-6 (atomics add in an order that
changes run to run).  The SSD chunk: f32 atol 1e-4 with rtol 1e-3 (kernel
and plain version sum the products in other orders); bf16 inputs atol
1e-2, rtol 1e-2 (both sum in f32 and part by at most one rounding of the
output to bf16).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
from repro_torch.core.coalescing import plan_buckets_sorted
from repro_torch.core.commit import BACKENDS, CommitSpec, commit
from repro_torch.core.messages import make_messages
from repro_torch.graphs.algorithms.bfs import (distributed_bfs,
                                                distributed_multi_source_bfs)
from repro_torch.graphs.algorithms.pagerank import distributed_pagerank
from repro_torch.graphs.algorithms.sssp import distributed_sssp
from repro_torch.graphs.generators import kronecker, random_weights
from repro_torch.kernels import ref
from repro_torch.kernels.coalesce import bucket_count_kernel
from repro_torch.kernels.coarse_commit import coarse_commit_kernel
from repro_torch.kernels.fused_wave import fused_route_commit_kernel
from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.serve.serve_step import generate, pad_cache

OPS_TYPES = [(op, dt) for op in ("min", "max", "add", "or", "first")
             for dt in (torch.int32, torch.float32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(op, dt, v, n, gen, device):
    if op == "first":
        state = torch.where(torch.rand(v, generator=gen) < 0.5, -1,
                            torch.randint(0, 50, (v,), generator=gen))
        val = torch.randint(0, 50, (n,), generator=gen)
    elif op == "or":
        state = torch.randint(0, 2, (v,), generator=gen)
        val = torch.randint(0, 2, (n,), generator=gen)
    else:
        state = torch.randint(-50, 50, (v,), generator=gen)
        val = torch.randint(-50, 50, (n,), generator=gen)
        if dt == torch.float32:
            val = val / 8.0
    return state.to(dt).to(device), val.to(dt).to(device)


def _assert_state(op, got, exp):
    if op == "add" and got.dtype == torch.float32:
        torch.testing.assert_close(got, exp, rtol=2e-4, atol=1e-6)
    else:
        assert torch.equal(got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("tile_m", [1, 7, 256, 4096])
@pytest.mark.parametrize("op,dt", OPS_TYPES,
                         ids=[f"{o}-{str(d)[6:]}" for o, d in OPS_TYPES])
def test_kernels_match_plain(cuda, op, dt, tile_m, stats):
    gen = torch.Generator().manual_seed(tile_m)
    v, n = 5000, 100_000
    state, val = _inputs(op, dt, v, n, gen, cuda)
    idx = torch.randint(-1, v + 100, (n,), generator=gen)
    idx[: n // 4] = torch.randint(0, 64, (n // 4,), generator=gen)
    idx = idx.to(torch.int32).to(cuda)
    lane = torch.randint(-1, 5, (n,), generator=gen).to(torch.int32)
    cases = [
        (coarse_commit_kernel, ref.coarse_commit_ref, (state, idx, val),
         dict(block_v=512)),
        (fused_route_commit_kernel, ref.fused_route_commit_ref,
         (state, idx, val), {}),
        (fused_route_commit_kernel, ref.fused_route_commit_ref,
         (state[:4000], idx + 300, val),
         dict(lane=lane.to(cuda), base=300, width=4)),
    ]
    for kernel, plain, args, kw in cases:
        before = kernel.launches
        got = kernel(*args, op=op, tile_m=tile_m, stats=stats, **kw)
        exp = plain(*args, op=op, tile_m=tile_m, stats=stats, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        if stats:
            (got, got_c), (exp, exp_c) = got, exp
            assert int(got_c) == int(exp_c)
        _assert_state(op, got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["min", "add", "first"])
def test_commit_tiers_agree_on_card(cuda, op):
    gen = torch.Generator().manual_seed(1)
    state, val = _inputs(op, torch.int32, 3000, 50_000, gen, cuda)
    tgt = torch.randint(0, 3000, (50_000,), generator=gen).to(cuda)
    valid = (torch.rand(50_000, generator=gen) < 0.8).to(cuda)
    msgs = make_messages(tgt, val, valid)
    res = {b: commit(state, msgs, op, CommitSpec(backend=b))
           for b in BACKENDS}
    for b in BACKENDS[1:]:
        for field in ("state", "success", "conflicts", "applied"):
            if field == "conflicts" and b in ("pallas", "fused"):
                continue        # per-tile count, not the whole-batch one
            assert torch.equal(getattr(res[b], field),
                               getattr(res["atomic"], field)), (b, field)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    st = torch.zeros(8, dtype=torch.int32, device=cuda)
    t = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        coarse_commit_kernel(st, t, t.float())
    with pytest.raises(ValueError, match="shared-memory"):
        coarse_commit_kernel(st, t, t, tile_m=1 << 15, stats=True)
    with pytest.raises(ValueError, match="contiguous"):
        coarse_commit_kernel(
            st, torch.zeros(8, dtype=torch.int32, device=cuda)[::2], t)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("n", [0, 1, 5, 1000, 100_003])
@pytest.mark.parametrize("nb", [1, 7, 32, 1000, 49152, 49153, 65536])
def test_bucket_count_matches_plain(cuda, nb, n, offset):
    """Shared-memory histogram up to 49152 buckets, global atomics above;
    ``offset`` starts the ids off the 16-byte boundary.  Ids from -2 to
    nb + 2 (masked outside [0, nb)); a third of them in one bucket."""
    gen = torch.Generator().manual_seed(nb * 7 + n + offset)
    ids = torch.randint(-2, nb + 3, (n + offset,), generator=gen)
    ids[: (n + offset) // 3] = 0
    owner = ids.to(torch.int32).to(cuda)[offset:]
    before = bucket_count_kernel.launches
    got = bucket_count_kernel(owner, nb)
    torch.cuda.synchronize()
    assert bucket_count_kernel.launches == before + (n > 0)
    assert torch.equal(got, ref.bucket_count_ref(owner, nb))
    assert int(got.sum()) == int(((owner >= 0) & (owner < nb)).sum())


@pytest.mark.cuda
def test_plan_buckets_sorted_launches_the_kernel(cuda):
    gen = torch.Generator().manual_seed(3)
    owner = torch.randint(0, 8, (50_000,), generator=gen).to(cuda)
    valid = (torch.rand(50_000, generator=gen) < 0.7).to(cuda)
    before = bucket_count_kernel.launches
    plan, order = plan_buckets_sorted(owner, valid, 8, 4096)
    assert bucket_count_kernel.launches == before + 1
    plan_j, order_j = plan_buckets_sorted(owner, valid, 8, 4096,
                                          count_backend="jnp")
    for f in ("owner", "position", "counts", "kept", "dropped"):
        assert torch.equal(getattr(plan, f), getattr(plan_j, f)), f
    assert torch.equal(order, order_j)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_engine_on_card_matches_cpu(cuda, backend):
    """World size 1 at Kronecker scale 12: the same answers and telemetry
    on the card as on the CPU."""
    out = {}
    for dev in ("cpu", "cuda"):
        g = kronecker(12, 16, seed=0, device=dev)
        gw = random_weights(g, seed=0)
        src = int(torch.argmax(g.degrees))
        mesh = make_mesh(device=dev)
        kw = dict(capacity=4096, spec=CommitSpec(backend=backend),
                  max_subrounds=256, telemetry=True)
        d, _, rb = distributed_bfs(mesh, g, src, **kw)
        s, _, rs = distributed_sssp(mesh, gw, src, **kw)
        p, rp = distributed_pagerank(mesh, g, iters=5, **kw)
        m, _, rm = distributed_multi_source_bfs(mesh, g, [src, 1, 2, 3], **kw)
        out[dev] = ([d.cpu(), s.cpu(), p.cpu() * g.num_vertices, m.cpu()],
                    [(r.rounds, r.subrounds, int(r.conflicts),
                      r.delivered_all) for r in (rb, rs, rp, rm)])
    (cpu, cpu_tel), (card, card_tel) = out["cpu"], out["cuda"]
    assert card_tel == cpu_tel
    assert all(t[3] for t in card_tel)
    for i, (a, b) in enumerate(zip(card, cpu)):
        if i == 2:
            torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-6)
        else:
            assert torch.equal(a, b)


def ssd_inputs(g, L, n, p, dtype, gen, device):
    """C, B, x normal in ``dtype``; a in f32 with cumsum(a) falling to
    about -250 over the chunk, as in a full-width prefill."""
    C, B = (torch.randn(g, L, n, generator=gen) for _ in range(2))
    x = torch.randn(g, L, p, generator=gen)
    a = -torch.rand(g, L, generator=gen) * (500.0 / L)
    return [t.to(dtype).to(device) for t in (C, B, x)] + [a.to(device)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,p", [(16, 16), (128, 64)])
@pytest.mark.parametrize("L", [1, 7, 64, 100, 125, 128])
def test_ssd_chunk_matches_plain(cuda, L, n, p, dtype):
    gen = torch.Generator().manual_seed(L * 7 + n)
    args = ssd_inputs(96, L, n, p, dtype, gen, cuda)
    before = ssd_chunk_kernel.launches
    got = ssd_chunk_kernel(*args)
    exp = ref.ssd_chunk_ref(*args)
    torch.cuda.synchronize()
    assert ssd_chunk_kernel.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, exp, atol=1e-4, rtol=1e-3)
    else:
        torch.testing.assert_close(got.float(), exp.float(), atol=1e-2,
                                   rtol=1e-2)


@pytest.mark.cuda
def test_ssd_chunk_rejects_what_it_does_not_take(cuda):
    gen = torch.Generator().manual_seed(0)
    C, B, x, a = ssd_inputs(4, 16, 16, 16, torch.float32, gen, cuda)
    with pytest.raises(ValueError, match="chunk length"):
        ssd_chunk_kernel(*ssd_inputs(2, 129, 16, 16, torch.float32, gen,
                                     cuda))
    with pytest.raises(ValueError, match="shared memory"):
        ssd_chunk_kernel(*ssd_inputs(2, 128, 16, 512, torch.float32, gen,
                                     cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk_kernel(C.transpose(0, 1).contiguous().transpose(0, 1), B,
                         x, a)
    with pytest.raises(TypeError):
        ssd_chunk_kernel(C, B.to(torch.bfloat16), x, a)
    with pytest.raises(TypeError):
        ssd_chunk_kernel(C, B, x, a.to(torch.bfloat16))
    with pytest.raises(TypeError):
        ssd_chunk_kernel(*(t.half() for t in (C, B, x)), a)
    with pytest.raises(NotImplementedError, match="backward"):
        ssd_chunk_kernel(C.requires_grad_(), B, x, a)


def _ssd_against_plain(args, dtype):
    before = ssd_chunk_kernel.launches
    got = ssd_chunk_kernel(*args)
    exp = ref.ssd_chunk_ref(*args)
    torch.cuda.synchronize()
    assert ssd_chunk_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == exp.shape
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, exp, atol=1e-4, rtol=1e-3)
    else:
        torch.testing.assert_close(got.float(), exp.float(), atol=1e-2,
                                   rtol=1e-2)


SSD_DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                     ids=["f32", "bf16"])


@pytest.mark.cuda
@SSD_DTYPES
@pytest.mark.parametrize("n,p", [(20, 24), (1, 1), (3, 5), (128, 72),
                                 (40, 64)])
@pytest.mark.parametrize("L", [17, 128])
def test_ssd_chunk_widths_off_the_vector_grid(cuda, L, n, p, dtype):
    """N and P that are not multiples of 4 (f32) or 8 (bf16) take scalar
    loads; P past one 64-column pass of S x takes a second pass."""
    gen = torch.Generator().manual_seed(L + 31 * n + p)
    _ssd_against_plain(ssd_inputs(40, L, n, p, dtype, gen, cuda), dtype)


@pytest.mark.cuda
@SSD_DTYPES
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_ssd_chunk_bases_at_element_offsets(cuda, offset, dtype):
    """Each input a contiguous slice of a larger buffer, starting
    ``offset`` elements in (so not 16-byte aligned), at layer 0's
    widths."""
    g, L, n, p = 24, 128, 128, 64
    gen = torch.Generator().manual_seed(offset)
    args = []
    for t in ssd_inputs(g, L, n, p, dtype, gen, cuda):
        buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=cuda)
        view = buf[offset:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        args.append(view)
    _ssd_against_plain(args, dtype)


@pytest.mark.cuda
@SSD_DTYPES
@pytest.mark.parametrize("g", [1, 100, 1001])
def test_ssd_chunk_cell_counts_against_the_persistent_grid(cuda, g, dtype):
    """One cell, fewer cells than the persistent grid has CTAs (132 SMs,
    two or more CTAs each), and a count that is not a multiple of it."""
    gen = torch.Generator().manual_seed(g)
    _ssd_against_plain(ssd_inputs(g, 128, 128, 64, dtype, gen, cuda), dtype)


@pytest.mark.cuda
@SSD_DTYPES
@pytest.mark.parametrize("n,p", [(128, 64), (16, 16)])
@pytest.mark.parametrize("L", [1, 17, 128])
def test_ssd_chunk_deep_decays(cuda, L, n, p, dtype):
    """cumsum(a) falls to about -250 over the chunk (``ssd_inputs``), so
    most decays underflow and the masked ones would overflow."""
    gen = torch.Generator().manual_seed(7 * L + n)
    args = ssd_inputs(300, L, n, p, dtype, gen, cuda)
    if L > 1:
        assert float(torch.cumsum(args[3], 1)[:, -1].mean()) < -200
    _ssd_against_plain(args, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_kernel_path_matches_plain_path(cuda, dtype):
    """A 2-layer smoke Mamba2 on the card: the prefill launches the SSD
    kernel once per layer, and its logits equal the einsum path's (within
    1e-4 of the largest in f32, 0.05 in bf16).  In f32 the greedy tokens of
    ``generate`` are equal too, at each step until the einsum path's top-2
    margin falls within that tolerance (a near-tie may flip)."""
    cfg = dataclasses.replace(smoke_model(ARCHS["mamba2-780m"]), num_layers=2)
    model = M.init(cfg, 0, device=cuda)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (2, 200), generator=gen,
                           dtype=torch.int32)
    s, n_new = prompt.shape[1], 8
    rcfgs, out = {}, {}
    for use_pallas in (True, False):
        rcfgs[use_pallas] = rcfg = RunConfig(
            model=cfg, shape=ShapeConfig("t", s + n_new, 2, "decode"),
            compute_dtype=dtype, use_pallas=use_pallas)
        before = ssd_chunk_kernel.launches
        logits, _ = M.prefill(cfg, rcfg, model, {"tokens": prompt.to(cuda)})
        assert ssd_chunk_kernel.launches - before == (
            cfg.num_layers if use_pallas else 0)
        toks = generate(cfg, rcfg, model, {"tokens": prompt},
                        max_new_tokens=n_new, device=cuda)
        out[use_pallas] = logits.float()[..., :cfg.vocab_size], toks
    (kl, kt), (pl, pt) = out[True], out[False]
    tol = 1e-4 if dtype == "float32" else 0.05
    assert float((kl - pl).abs().max()) <= tol * float(pl.abs().max())
    if dtype != "float32":
        return
    # the einsum path's logits at each step, for the margin rule
    logits, cache = M.prefill(cfg, rcfgs[False], model,
                              {"tokens": prompt.to(cuda)})
    cache = pad_cache(cfg, cache, s + n_new)
    for i in range(n_new):
        top2 = logits[:, 0, :cfg.vocab_size].float().topk(2).values
        if float((top2[:, 0] - top2[:, 1]).min()) <= \
                tol * float(top2.abs().max()):
            break
        assert torch.equal(kt[:, i], pt[:, i]), f"step {i}"
        logits, cache = M.decode_step(cfg, rcfgs[False], model, cache,
                                      pt[:, i:i + 1], s + i)
    assert i > 0, "the first step was already a near-tie"


def _commit_cases(state, idx, val, lane=None, base=None, width=1):
    """(kernel, plain, args, kw) of both commit kernels on one batch: the
    coarse kernel on ``idx``, the fused kernel on ``idx`` as global ids
    (with ``lane``, ``base`` and ``width`` when given)."""
    fused_kw = {} if lane is None else dict(lane=lane, base=base,
                                            width=width)
    return [(coarse_commit_kernel, ref.coarse_commit_ref, (state, idx, val),
             dict(block_v=512)),
            (fused_route_commit_kernel, ref.fused_route_commit_ref,
             (state, idx, val), fused_kw)]


def _check_commit(state, idx, val, op, stats=False, **fused):
    for kernel, plain, args, kw in _commit_cases(state, idx, val, **fused):
        before = kernel.launches
        got = kernel(*args, op=op, stats=stats, **kw)
        exp = plain(*args, op=op, stats=stats, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        if stats:
            (got, got_c), (exp, exp_c) = got, exp
            assert int(got_c) == int(exp_c)
        _assert_state(op, got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("op,dt", OPS_TYPES,
                         ids=[f"{o}-{str(d)[6:]}" for o, d in OPS_TYPES])
def test_commit_all_messages_to_one_target(cuda, op, dt):
    """The hottest case: 600,000 messages (several CTAs) to one slot: each
    warp merges its messages, and one table slot of each CTA combines
    them."""
    gen = torch.Generator().manual_seed(11)
    state, val = _inputs(op, dt, 4096, 600_000, gen, cuda)
    if op == "first":
        state[1234] = -1
    idx = torch.full((600_000,), 1234, dtype=torch.int32, device=cuda)
    _check_commit(state, idx, val, op)


@pytest.mark.cuda
@pytest.mark.parametrize("op,dt", OPS_TYPES,
                         ids=[f"{o}-{str(d)[6:]}" for o, d in OPS_TYPES])
def test_commit_more_keys_than_table_slots(cuda, op, dt):
    """2**20 messages over 2**21 targets: more distinct keys in a
    CTA's span than its table has slots, so most go to device memory
    directly; a quarter go to 64 hot targets."""
    gen = torch.Generator().manual_seed(12)
    v, n = 1 << 21, 1 << 20
    state, val = _inputs(op, dt, v, n, gen, cuda)
    idx = torch.randint(0, v, (n,), generator=gen)
    idx[::4] = torch.randint(0, 64, (n // 4,), generator=gen)
    _check_commit(state, idx.to(torch.int32).to(cuda), val, op)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
def test_first_lowest_index_wins_across_ctas(cuda, stats):
    """Each of 1000 targets gets messages from every part of a 2,000,000
    message batch (every CTA of the grid): the lowest index
    wins, whatever span it lies in."""
    gen = torch.Generator().manual_seed(13)
    n = 2_000_000
    state, val = _inputs("first", torch.int32, 1000, n, gen, cuda)
    idx = (torch.randperm(n, generator=gen) % 1000).to(torch.int32)
    _check_commit(state, idx.to(cuda), val, "first", stats=stats)


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 1), (1, 0), (0, 3), (2, 2)],
                         ids=["idx1-val1", "idx1-val0", "idx0-val3",
                              "idx2-val2"])
@pytest.mark.parametrize("op", ["min", "add", "first"])
def test_commit_on_unaligned_slices(cuda, op, offsets):
    """Message arrays that start 1-3 elements past a 16-byte boundary, at
    the same offset (a scalar head, then 16-byte loads) or at different
    ones (scalar loads throughout)."""
    gen = torch.Generator().manual_seed(14 + sum(offsets))
    v, n = 5000, 300_001
    oi, ov = offsets
    state, val = _inputs(op, torch.float32, v, n + ov, gen, cuda)
    raw = torch.randint(-1, v + 10, (n + oi,), generator=gen).to(
        torch.int32).to(cuda)
    lane = torch.randint(0, 4, (n + oi,), generator=gen).to(
        torch.int32).to(cuda)
    idx, g_tgt, lane, val = raw[oi:], (raw + 200)[oi:], lane[oi:], val[ov:]
    assert idx.data_ptr() % 16 == 4 * oi and val.data_ptr() % 16 == 4 * ov
    _check_commit(state, idx, val, op)
    _check_commit(state[:4000], g_tgt, val, op, lane=lane, base=200,
                  width=4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 4099])
@pytest.mark.parametrize("op,dt", OPS_TYPES,
                         ids=[f"{o}-{str(d)[6:]}" for o, d in OPS_TYPES])
def test_commit_small_batches(cuda, op, dt, n):
    """N = 1 and N not a multiple of 4: the scalar tail alone."""
    gen = torch.Generator().manual_seed(15 + n)
    state, val = _inputs(op, dt, 64, n, gen, cuda)
    idx = torch.randint(-1, 70, (n,), generator=gen).to(torch.int32).to(cuda)
    _check_commit(state, idx, val, op)


@pytest.mark.cuda
@pytest.mark.parametrize("op,dt", OPS_TYPES,
                         ids=[f"{o}-{str(d)[6:]}" for o, d in OPS_TYPES])
def test_fused_width4_with_device_base(cuda, op, dt):
    """The engine's lane layout: key (tgt - base) * 4 + lane, ``base`` a
    device scalar, targets of other shards and bad lanes dropped."""
    gen = torch.Generator().manual_seed(16)
    rows, n, base = 30_000, 400_000, 70_000
    state, val = _inputs(op, dt, rows * 4, n, gen, cuda)
    tgt = torch.randint(base - 1000, base + rows + 1000, (n,), generator=gen)
    tgt[: n // 8] = -1
    lane = torch.randint(-1, 5, (n,), generator=gen).to(torch.int32)
    base_t = torch.tensor(base, dtype=torch.int32, device=cuda)
    got = fused_route_commit_kernel(state, tgt.to(torch.int32).to(cuda), val,
                                    lane=lane.to(cuda), base=base_t, width=4,
                                    op=op)
    exp = ref.fused_route_commit_ref(state, tgt.to(torch.int32).to(cuda), val,
                                     lane=lane.to(cuda), base=base_t,
                                     width=4, op=op)
    torch.cuda.synchronize()
    _assert_state(op, got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("op,dt", OPS_TYPES,
                         ids=[f"{o}-{str(d)[6:]}" for o, d in OPS_TYPES])
def test_commit_on_sorted_targets(cuda, op, dt):
    """Sorted targets, masked ones first: runs of one key from 1 to
    thousands of messages, merged within a thread, across a warp whose
    lanes all hold one key, or not at all where a run ends."""
    gen = torch.Generator().manual_seed(17)
    v, n = 100_000, 1_000_000
    state, val = _inputs(op, dt, v, n, gen, cuda)
    idx = torch.randint(-1, v, (n,), generator=gen)
    idx[::3] = torch.randint(0, 100, (idx[::3].shape[0],), generator=gen)
    idx = torch.sort(idx).values.to(torch.int32).to(cuda)
    _check_commit(state, idx, val, op)
    _check_commit(state, idx, val, op, stats=True)


@pytest.mark.cuda
@pytest.mark.parametrize("op,dt", OPS_TYPES,
                         ids=[f"{o}-{str(d)[6:]}" for o, d in OPS_TYPES])
def test_commit_at_full_size(cuda, op, dt):
    """V = 2**21, N = 2**26 with the Graph500 in-degree skew (each id bit
    1 with probability 0.24) and a tenth of the messages masked."""
    gen = torch.Generator(device=cuda).manual_seed(18)
    v, n = 1 << 21, 1 << 26
    key = torch.zeros(n, dtype=torch.int64, device=cuda)
    for _ in range(21):
        key = key * 2 + (torch.rand(n, generator=gen, device=cuda)
                         < 0.24).long()
    idx = torch.randperm(v, generator=gen, device=cuda)[key]
    idx = torch.where(torch.rand(n, generator=gen, device=cuda) < 0.1, -1,
                      idx).to(torch.int32)
    del key
    state, val = _inputs(op, dt, v, n, torch.Generator().manual_seed(19),
                         cuda)
    _check_commit(state, idx, val, op)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["min", "add"])
def test_commit_without_stats_launches_no_fill(cuda, op):
    """A ``stats=False`` commit launches the state copy and the commit
    kernel and nothing else: no fill of an unused conflict counter."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(20)
    state, val = _inputs(op, torch.int32, 5000, 100_000, gen, cuda)
    idx = torch.randint(0, 5000, (100_000,), generator=gen).to(
        torch.int32).to(cuda)
    for kernel, _, args, kw in _commit_cases(state, idx, val):
        kernel(*args, op=op, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kernel(*args, op=op, **kw)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type.name == "CUDA"]
        assert any("commit_span" in k for k in names), names
        assert not [k for k in names if "fill" in k.lower()
                    or "commit_span" not in k and "Memcpy" not in k], names


# -- st-connectivity, coloring, Boruvka, the graph batch and lane forms ----

def _graph_slice_outputs(dev, backend):
    """Every single-shard entry of st-connectivity, coloring and Boruvka,
    the lane forms of st-connectivity and PageRank, and the six
    ``batched_over_graphs_*`` (single-shard and ``mesh=``) on ``dev``, as
    CPU tensors keyed by name (ranks scaled by V)."""
    from repro_torch.graphs.algorithms import (bfs, boruvka, coloring,
                                               pagerank, sssp, stconn)
    from repro_torch.graphs.csr import GraphSet
    spec = CommitSpec(backend=backend, stats=False)
    g = random_weights(kronecker(12, 16, seed=0, device=dev), seed=0)
    deg = g.degrees.cpu()
    hub, lone = int(torch.argmax(deg)), int(torch.nonzero(deg == 0)[0])
    dist = bfs.bfs(g, hub, spec=spec).dist
    far = int(torch.argmax(torch.where(dist < 2 ** 29, dist, -1)))
    out = {}
    for name, t in (("connected", far), ("disconnected", lone),
                    ("s == t", hub)):
        found, rounds = stconn.st_connectivity(g, hub, t, spec=spec)
        out[f"stconn {name}"] = torch.tensor([int(found), rounds])
    ss, ts = [hub, 1, 2, hub], [far, lone, 2, 3]
    found, rounds = stconn.multi_source_stconn(g, ss, ts, spec=spec)
    out["multi_stconn"] = torch.cat([found.int().cpu(),
                                     torch.tensor([rounds])])
    color, rounds, nc = coloring.coloring(g, seed=1, spec=spec)
    assert coloring.validate_coloring(g, color) and not bool(nc)
    out["coloring"] = torch.cat([color.cpu(), torch.tensor([rounds])])
    comp, sel, rounds = boruvka.boruvka_forest(g, spec=spec)
    out["boruvka"] = torch.cat([comp.cpu(), sel.int().cpu(),
                                torch.tensor([rounds])])
    out["boruvka weight"] = boruvka.boruvka(g, spec=spec)[1].cpu()
    rank, _ = pagerank.multi_source_pagerank(g, [hub, 1, 2], iters=5,
                                             spec=spec)
    out["multi_ppr"] = rank.cpu() * g.num_vertices
    gs = GraphSet([random_weights(kronecker(s, 8, seed=s, device=dev),
                                  seed=s) for s in (8, 9, 10)])
    srcs = [int(torch.argmax(m.degrees)) for m in gs.graphs]
    mesh = make_mesh(device=dev)
    for route, kw in (("", {}), (" mesh", dict(mesh=mesh, capacity=4096,
                                               max_subrounds=256))):
        kw = dict(kw, spec=spec)
        out["gb_bfs" + route] = torch.cat(
            bfs.batched_over_graphs_bfs(gs, srcs, **kw)).cpu()
        out["gb_sssp" + route] = torch.cat(
            sssp.batched_over_graphs_sssp(gs, srcs, **kw)).cpu()
        out["gb_ppr" + route] = torch.cat(
            pagerank.batched_over_graphs_pagerank(gs, srcs, iters=5,
                                                  **kw)).cpu() * 1e3
        out["gb_stconn" + route] = stconn.batched_over_graphs_stconn(
            gs, srcs, [0, 1, 2], **kw).cpu()
        colors, rounds, nc = coloring.batched_over_graphs_coloring(
            gs, seed=1, **kw)
        out["gb_coloring" + route] = torch.cat(
            [c.cpu() for c in colors] + [nc.int().cpu(),
                                         torch.tensor([rounds])])
        trees, rounds = boruvka.batched_over_graphs_boruvka(gs, **kw)
        out["gb_boruvka" + route] = torch.cat(
            [c.cpu() for c, _, _ in trees]
            + [torch.stack([n for _, _, n in trees]).cpu(),
               torch.tensor([rounds])])
        out["gb_boruvka weight" + route] = torch.stack(
            [w for _, w, _ in trees]).cpu()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_graph_slice_on_card_matches_cpu(cuda, backend):
    """Kronecker scale 12 and three tenants of scales 8-10: the same
    answers on the card as on the CPU; float sums (ranks, MST weights)
    within rtol 2e-4 / 1e-5."""
    card = _graph_slice_outputs("cuda", backend)
    cpu = _graph_slice_outputs("cpu", backend)
    assert card.keys() == cpu.keys()
    for key, exp in cpu.items():
        got = card[key]
        if "ppr" in key:
            torch.testing.assert_close(got, exp, rtol=2e-4, atol=1e-6)
        elif "weight" in key:
            torch.testing.assert_close(got, exp, rtol=1e-5, atol=0.0)
        else:
            assert torch.equal(got, exp), key


def _engine_slice_outputs(dev, backend):
    """The wave-engine forms of st-connectivity, coloring and Boruvka, the
    lane forms of SSSP, PageRank and st-connectivity, and the product BFS
    at world size 1 on ``dev``: outputs as CPU tensors and telemetry."""
    from repro_torch.graphs.algorithms import (bfs, boruvka, coloring,
                                               pagerank, sssp, stconn)
    from repro_torch.graphs.csr import GraphSet
    g = random_weights(kronecker(12, 16, seed=0, device=dev), seed=0)
    hub = int(torch.argmax(g.degrees))
    lone = int(torch.nonzero(g.degrees == 0)[0])
    dist = bfs.bfs(g, hub).dist
    far = int(torch.argmax(torch.where(dist < 2 ** 29, dist, -1)))
    mesh = make_mesh(device=dev)
    kw = dict(capacity=4096, spec=CommitSpec(backend=backend),
              max_subrounds=256, telemetry=True)
    gs = GraphSet([kronecker(s, 8, seed=s, device=dev) for s in (8, 9)])
    runs = {
        "stconn": lambda: stconn.distributed_stconn(mesh, g, hub, far,
                                                    **kw),
        "coloring": lambda: coloring.distributed_coloring(mesh, g, **kw),
        "boruvka": lambda: boruvka.distributed_boruvka(mesh, g, **kw),
        "multi_sssp": lambda: sssp.distributed_multi_source_sssp(
            mesh, g, [hub, 1, 2], **kw),
        "multi_ppr": lambda: pagerank.distributed_multi_source_pagerank(
            mesh, g, [hub, 1, 2], iters=5, **kw),
        "multi_stconn": lambda: stconn.distributed_multi_source_stconn(
            mesh, g, [hub, hub, 1], [far, lone, 1], **kw),
        "product_bfs": lambda: bfs.distributed_product_bfs(
            mesh, gs, [[0, 1], [7, 3]], **kw),
    }
    out = {}
    for name, run in runs.items():
        *res, tel = run()
        out[name] = ([torch.as_tensor(r).cpu() for r in res],
                     (tel.rounds, tel.subrounds, int(tel.conflicts),
                      tel.delivered_all))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_engine_slice_on_card_matches_cpu(cuda, backend):
    card = _engine_slice_outputs("cuda", backend)
    cpu = _engine_slice_outputs("cpu", backend)
    for name, (exp, exp_tel) in cpu.items():
        got, tel = card[name]
        assert tel == exp_tel and tel[3], name
        for a, b in zip(got, exp):
            if name == "multi_ppr":
                torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-6)
            elif a.dtype == torch.float32 and name == "boruvka":
                torch.testing.assert_close(a, b, rtol=1e-5, atol=0.0)
            else:
                assert torch.equal(a, b), name


def _graph_round_batches(dev):
    """The message batches of one st-connectivity round (``first``: each
    live edge's color into white slots) and one coloring round (``or``:
    a 1 to each conflicting edge's loser) on Kronecker scale 14, as
    (op, state, idx with -1 masked, val)."""
    from repro_torch.graphs.algorithms import coloring as CO
    from repro_torch.graphs.algorithms import stconn as ST
    g = kronecker(14, 16, seed=1, device=dev)
    v = g.num_vertices
    hub = int(torch.argmax(g.degrees))
    color = torch.full((v,), ST.WHITE, dtype=torch.int32, device=dev)
    nbrs = g.dst[g.src == hub].long()
    color[nbrs] = ST.GREY          # the grey wave after one round
    color[hub] = ST.GREY
    color[3] = ST.GREEN
    active = (color[g.src] != ST.WHITE)
    first = ("first", color, torch.where(active, g.dst, -1),
             color[g.src].contiguous())
    pal = int(g.degrees.max()) + 1
    c = CO._propose(torch.arange(v, device=dev),
                    torch.ones(v, dtype=torch.bool, device=dev),
                    torch.zeros(v, dtype=torch.int32, device=dev),
                    min(pal, 8), 0, 0)         # a small palette: conflicts
    loser = CO._pair_loser(g.src, g.dst, 0, 0)
    ors = ("or", torch.zeros(v, dtype=torch.int32, device=dev),
           torch.where(c[g.src] == c[g.dst], loser, -1),
           torch.ones(g.num_edges, dtype=torch.int32, device=dev))
    return first, ors


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
def test_first_and_or_match_plain_on_graph_rounds(cuda, stats):
    for op, state, idx, val in _graph_round_batches(cuda):
        assert (idx >= 0).any() and (idx < 0).any(), op
        for kernel, plain, args, kw in _commit_cases(state, idx, val):
            got = kernel(*args, op=op, stats=stats, **kw)
            exp = plain(*args, op=op, stats=stats, **kw)
            if stats:
                (got, got_c), (exp, exp_c) = got, exp
                assert int(got_c) == int(exp_c), op
            assert torch.equal(got, exp), op
            assert not torch.equal(got, state), op


# -- the tuned, traced and sanitised commit on the card ---------------------


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("backend", ["atomic", "coarse"])
def test_bool_state_min_max_on_card(cuda, op, backend):
    """The tuner calibrates ``min`` on whatever dtype a state leaf has,
    bool included; CUDA has no bool scatter-reduce."""
    gen = torch.Generator().manual_seed(11)
    state = torch.rand(97, generator=gen) < 0.5
    msgs = make_messages(torch.randint(0, 97, (400,), generator=gen),
                         torch.rand(400, generator=gen) < 0.5)
    spec = CommitSpec(backend=backend, stats=False)
    exp = commit(state, msgs, op, spec).state
    got = commit(state.to(cuda), _to(msgs, cuda), op, spec).state
    assert torch.equal(got.cpu(), exp)


def _to(msgs, dev):
    return dataclasses.replace(msgs, target=msgs.target.to(dev),
                               payload=msgs.payload.to(dev),
                               valid=msgs.valid.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
def test_auto_on_card_keeps_the_kernel_tiers_and_matches_cpu(
        cuda, stats, tmp_path, monkeypatch):
    from repro_torch.core import autotune as AT
    from repro_torch.graphs.algorithms.bfs import bfs
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "cache.json"))
    tuner = AT.AutoTuner(ns=(4, 16), v_cal=256)
    monkeypatch.setattr(AT, "DEFAULT_TUNER", tuner)
    g = kronecker(12, 16, seed=0, device=cuda)
    spec = CommitSpec(backend="auto", stats=stats)
    got = bfs(g, 0, spec=spec).dist
    exp = bfs(kronecker(12, 16, seed=0, device="cpu"), 0,
              spec=CommitSpec(backend="coarse", stats=False)).dist
    assert torch.equal(got.cpu(), exp)
    cals = [e for e in tuner.audit if e["event"] == "calibrate"]
    assert cals and all({"pallas", "fused"} <= set(e["tiers"])
                        for e in cals)
    assert all(e["event"] != "kernel_tiers_excluded" for e in tuner.audit)
    assert all(e["device"] == torch.cuda.get_device_name(cuda)
               for e in cals)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", ["min", "max", "add", "or", "first"])
def test_sanitize_on_card_is_clean(cuda, backend, op):
    from repro_torch.analysis import sanitize as SAN
    gen = torch.Generator().manual_seed(5)
    v, n = 512, 20000
    state, val = _inputs(op, torch.int32, v, n, gen, cuda)
    msgs = make_messages(torch.randint(0, v, (n,), generator=gen).to(cuda),
                         val)
    SAN.clear_reports()
    for tile_m in (16, 4096):
        commit(state, msgs, op, CommitSpec(backend=backend, tile_m=tile_m,
                                           sanitize=True))
    assert SAN.reports() == ()


@pytest.mark.cuda
def test_run_transactions_and_degraded_bfs_on_card_match_cpu(cuda):
    from repro_torch.core.ownership import run_transactions
    txns = torch.randint(0, 4096, (1, 2048, 6),
                         generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    out = [run_transactions(make_mesh(device=dev), txns.to(dev), 4096,
                            capacity=1 << 14) for dev in (cuda, "cpu")]
    assert torch.equal(out[0][0].cpu(), out[1][0])
    assert out[0][1] == out[1][1] and out[0][1].retries > 0

    def drop(chunk, rounds_done):
        if chunk == 1:
            raise RuntimeError("simulated host drop")
    res = []
    for dev in (cuda, "cpu"):
        g = kronecker(12, 16, seed=0, device=dev)
        res.append(distributed_bfs(make_mesh(device=dev), g, 0,
                                   snapshot_rounds=1, fault_injector=drop,
                                   telemetry=True))
    assert torch.equal(res[0][0].cpu(), res[1][0])
    assert res[0][-1].degraded and res[0][1] == res[1][1]


@pytest.mark.cuda
def test_wavetap_records_on_card_match_cpu(cuda):
    from repro_torch.graphs.algorithms.bfs import bfs
    from repro_torch.obs import wavetap
    recs = []
    for dev in (cuda, "cpu"):
        wavetap.clear()
        bfs(kronecker(12, 16, seed=0, device=dev), 0,
            spec=CommitSpec(backend="pallas", trace=True))
        distributed_bfs(make_mesh(device=dev),
                        kronecker(12, 16, seed=0, device=dev), 0,
                        spec=CommitSpec(backend="pallas", trace=True))
        recs.append([{k: v for k, v in r.items() if k != "t"}
                     for r in wavetap.records()])
    wavetap.clear()
    assert recs[0] and recs[0] == recs[1]


def _serve_graphs(dev):
    from repro_torch.graphs.generators import erdos_renyi
    graphs = {"hot": random_weights(kronecker(12, 16, seed=0, device=dev),
                                    seed=1)}
    for i in range(3):
        graphs[f"t{i}"] = random_weights(
            erdos_renyi(200 + 50 * i, 6.0, seed=i, device=dev), seed=i)
    return graphs


def _serve_stream(Q):
    return ([("hot", Q.BfsQuery(s)) for s in (0, 5, 9)]
            + [("hot", Q.SsspQuery(s)) for s in (0, 5)]
            + [("hot", Q.PprQuery(s, iters=5)) for s in (0, 5)]
            + [("hot", Q.StConnQuery(0, s)) for s in (7, 4095)]
            + [(f"t{i}", q) for i in range(3) for q in (
                Q.BfsQuery(i), Q.SsspQuery(i), Q.PprQuery(i, iters=5),
                Q.StConnQuery(0, 100 + i), Q.ColoringQuery(), Q.MstQuery())])


def _same_answer(a, b):
    if isinstance(b, bool):
        assert a == b
    elif isinstance(b, tuple):
        assert torch.equal(a[0].cpu(), b[0].cpu())
        torch.testing.assert_close(a[1].cpu(), b[1].cpu(), rtol=1e-5,
                                   atol=0.0)
        assert int(a[2]) == int(b[2])
    elif b.dtype == torch.float32 and not torch.equal(a.cpu(), b.cpu()):
        torch.testing.assert_close(a.cpu(), b.cpu(), rtol=2e-4, atol=1e-6)
    else:
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("product", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_service_on_card_matches_cpu(cuda, backend, product):
    from repro_torch.serve import queries as Q
    from repro_torch.serve.graph_service import GraphService
    out, stats = [], []
    for dev in (cuda, "cpu"):
        svc = GraphService(spec=CommitSpec(backend=backend, stats=False),
                           max_lanes=4, max_graphs=4, product=product)
        for gid, g in _serve_graphs(dev).items():
            svc.register_graph(gid, g)
        tickets = [svc.submit(gid, q) for gid, q in _serve_stream(Q)]
        svc.drain()
        out.append([svc.result(t) for t in tickets])
        stats.append({f: getattr(svc.stats, f) for f in svc.stats._COUNTERS
                      if f not in ("drain_s",)})
    assert stats[0] == stats[1]
    for (gid, q), a, b in zip(_serve_stream(Q), *out):
        if isinstance(a, torch.Tensor):
            assert a.device.type == "cuda"
        _same_answer(a, b)


@pytest.mark.cuda
def test_product_wave_on_card_harvests_in_one_read(cuda):
    from repro_torch.graphs.csr import GraphSet
    from repro_torch.serve import queries as Q
    from repro_torch.serve.product_wave import ProductWave
    gs = GraphSet(list(_serve_graphs(cuda).values()))
    for kind, make in (("bfs", lambda i: Q.BfsQuery(i)),
                       ("stconn", lambda i: Q.StConnQuery(i, 3 * i + 1)),
                       ("ppr", lambda i: Q.PprQuery(i, iters=3))):
        wave = ProductWave(kind, gs, 2, spec=CommitSpec(backend="pallas",
                                                        stats=False),
                           fuse={"iters": 3, "d": 0.85}, round_chunk=1)
        for g in range(gs.num_graphs):
            wave.insert(g % 2, g, make(g))
        while True:
            flags = wave.done_cells()
            for lane in range(2):
                for g in range(gs.num_graphs):
                    assert flags[lane, g] == wave.cell_done(lane, g)
            if wave.run_chunk():
                break
        row = wave.extract(0, 0)
        kept = row.clone() if isinstance(row, torch.Tensor) else row
        wave.release(0, 0)
        wave.insert(0, 0, make(7))
        wave.run()
        if isinstance(row, torch.Tensor):
            assert torch.equal(row, kept)


@pytest.mark.cuda
def test_supervised_continuous_serving_on_card(cuda, tmp_path):
    """A kill mid-wave under a ServiceSupervisor on the card: every
    ticket answered once, equal to a CPU service's answers; the restored
    service lives on the card."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.serve import queries as Q
    from repro_torch.serve.continuous import ContinuousServer
    from repro_torch.serve.durable import ServiceSupervisor
    from repro_torch.serve.graph_service import GraphService
    spec = CommitSpec(backend="fused", stats=False)
    svc = GraphService(spec=spec, cache=False)
    for gid, g in _serve_graphs(cuda).items():
        svc.register_graph(gid, g)
    sup = ServiceSupervisor(svc, Checkpointer(tmp_path), log=lambda *a: None)
    sup.save()
    kills = []

    def injector(where, i):
        if where == "continuous" and not kills and i == 2:
            kills.append(i)
            raise RuntimeError("injected kill")
    svc.fault_injector = injector
    with ContinuousServer(sup, max_wait_s=0.01, round_chunk=1) as cs:
        tickets = [cs.submit(gid, q) for gid, q in _serve_stream(Q)]
        rows = cs.results(tickets, timeout=600)
    assert kills and sup.restarts == 1
    assert sorted(cs.done_at) == sorted(tickets)
    assert all(g.device.type == "cuda"
               for g in sup.service._graphs.values())
    ref = GraphService(spec=spec, cache=False)
    for gid, g in _serve_graphs("cpu").items():
        ref.register_graph(gid, g)
    want = [ref.submit(gid, q) for gid, q in _serve_stream(Q)]
    ref.drain()
    for a, t in zip(rows, want):
        _same_answer(a, ref.result(t))


# ---------------------------------------------------------------------------
# every decoder family and whisper at smoke width
# ---------------------------------------------------------------------------

FAMILY_TOL = {"float32": 1e-4, "bfloat16": 0.05}


def _family_batch(cfg, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 80),
                                     generator=gen, dtype=torch.int32)}
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                      generator=gen)
    if cfg.frontend == "patch":
        batch["patch_embeds"] = torch.randn(2, cfg.frontend_seq, cfg.d_model,
                                            generator=gen)
    return {k: v.to(device) for k, v in batch.items()}


def _rel(a, b):
    return float((a.float().cpu() - b.float().cpu()).abs().max()
                 / b.float().cpu().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ARCHS))
def test_family_on_card_matches_cpu(cuda, name):
    """The same weights on the CPU and the card, f32: the prefill's logits
    and 4 decode steps fed the CPU's greedy tokens within 1e-4 of the
    largest logit; on the card the bucket-count kernel launches once per
    MoE layer per forward and the SSD kernel once per Mamba layer per
    prefill."""
    cfg = smoke_model(ARCHS[name])
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", 100, 2, "decode"),
                     compute_dtype="float32", use_pallas=True)
    cpu_model = M.init(cfg, 3, device="cpu")
    card_model = M.init(cfg, 3, device="cpu").to(cuda)
    n_moe = sum(s.mlp == "moe" for s in cfg.full_pattern) * cfg.num_blocks
    n_ssm = sum(s.mixer == "mamba" for s in cfg.full_pattern) \
        * cfg.num_blocks
    outs = {}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
        batch = _family_batch(cfg, dev)
        counts = (bucket_count_kernel.launches, ssd_chunk_kernel.launches)
        logits, cache = M.prefill(cfg, rcfg, model, batch)
        if dev == "cuda":
            assert bucket_count_kernel.launches - counts[0] == n_moe
            assert ssd_chunk_kernel.launches - counts[1] == n_ssm
        prompt = batch["tokens"].shape[1] + (
            cfg.frontend_seq if cfg.frontend == "patch" else 0)
        outs[dev] = (logits, pad_cache(cfg, cache, prompt + 4), prompt)
    (cl, cc, prompt), (gl, gc, _) = outs["cpu"], outs["cuda"]
    v = cfg.vocab_size
    assert _rel(gl[..., :v], cl[..., :v]) <= FAMILY_TOL["float32"]
    for i in range(4):
        tok = cl.argmax(-1).to(torch.int32)
        cl, cc = M.decode_step(cfg, rcfg, cpu_model, cc, tok, prompt + i)
        gl, gc = M.decode_step(cfg, rcfg, card_model, gc, tok.to(cuda),
                               prompt + i)
        assert _rel(gl[..., :v], cl[..., :v]) <= FAMILY_TOL["float32"], i


@pytest.mark.cuda
@pytest.mark.parametrize("buckets,k", [(16, 2), (128, 8)])
@pytest.mark.parametrize("t", [1, 512, 8192])
def test_moe_plans_on_card_match_bincount(cuda, buckets, k, t):
    """MoE owner ids at N = T x k (each token's k distinct experts, as
    phi3.5 and qwen3-moe route them): the kernel-counted plan equals the
    ``torch.bincount`` plan, for dropless and train capacities."""
    gen = torch.Generator(device=cuda).manual_seed(t + buckets)
    owner = torch.rand(t, buckets, generator=gen, device=cuda) \
        .topk(k, -1).indices.reshape(-1).to(torch.int32)
    valid = torch.ones_like(owner, dtype=torch.bool)
    for cap in (t * k, max(8, t * k // buckets)):
        before = bucket_count_kernel.launches
        pk, ok = plan_buckets_sorted(owner, valid, buckets, cap,
                                     count_backend="pallas")
        assert bucket_count_kernel.launches == before + 1
        pj, oj = plan_buckets_sorted(owner, valid, buckets, cap,
                                     count_backend="jnp")
        for field in ("owner", "position", "counts", "kept", "dropped"):
            assert torch.equal(getattr(pk, field), getattr(pj, field)), field
        assert torch.equal(ok, oj)
        assert torch.equal(pk.counts, torch.bincount(
            owner.long(), minlength=buckets).to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jamba_ssd_kernel_path_matches_einsum_path(cuda, dtype):
    """jamba at smoke width on the card: the prefill's Mamba layers through
    the SSD kernel (one launch each) against the einsum path, logits
    within 1e-4 (f32) or 0.05 (bf16) of the largest."""
    cfg = smoke_model(ARCHS["jamba-1.5-large-398b"])
    model = M.init(cfg, 0, device=cuda)
    batch = _family_batch(cfg, cuda, seed=5)
    n_ssm = sum(s.mixer == "mamba" for s in cfg.full_pattern)
    out = {}
    for use_pallas in (True, False):
        rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", 80, 2, "prefill"),
                         compute_dtype=dtype, use_pallas=use_pallas)
        before = ssd_chunk_kernel.launches
        out[use_pallas], _ = M.prefill(cfg, rcfg, model, batch)
        assert ssd_chunk_kernel.launches - before == (n_ssm if use_pallas
                                                      else 0)
    v = cfg.vocab_size
    assert _rel(out[True][..., :v], out[False][..., :v]) <= FAMILY_TOL[dtype]


# -- training ---------------------------------------------------------------

TRAIN_FAMILIES = ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
                  "pixtral-12b", "whisper-small"]
# the CPU tests' bounds: losses, gradients, an update from the same
# gradients; whisper's bf16 cross K/V hold its gradients within 2**-8 of
# each leaf's largest (test_torch_train.py)
TRAIN_LOSS_RTOL, GRAD_RTOL, GRAD_ATOL, UPDATE_ATOL = 1e-5, 1e-4, 1e-6, 1e-6


def _train_on(cfg, rcfg, base, device, steps):
    import copy
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step
    model = copy.deepcopy(base).to(device)
    params = dict(model.named_parameters())
    opt_state = make_optimizer(rcfg).init(params)
    step = make_train_step(cfg, rcfg, model)
    stream = TokenStream(cfg, rcfg.shape, seed=0)
    losses = []
    for i in range(steps):
        params, opt_state, m = step(params, opt_state, i,
                                    stream.tensors(i, device=device))
        losses.append(m["loss"].item())
    return losses, {k: v.detach().cpu() for k, v in params.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_train_steps_on_card_match_cpu(cuda, arch):
    """Each family at smoke width, f32, remat full, from the same weights
    on the card and on the CPU: two train steps' losses within rtol 1e-5;
    the first step's gradients within rtol 1e-4 / atol 1e-6; one AdamW
    update from the CPU's gradients within atol 1e-6.  (Parameters after
    whole steps are not compared: AdamW's first steps are about lr
    sign(g), so a gradient at rounding level moves its parameter by up to
    lr on one device and not the other.)"""
    import copy
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import grads_fn
    cfg = smoke_model(ARCHS[arch])
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", 64, 4, "train"),
                     compute_dtype="float32", remat="full")
    base = M.init(cfg, 0, device="cpu")
    l_gpu, _ = _train_on(cfg, rcfg, base, cuda, 2)
    l_cpu, _ = _train_on(cfg, rcfg, base, "cpu", 2)
    for a, b in zip(l_gpu, l_cpu):
        assert abs(a - b) <= TRAIN_LOSS_RTOL * abs(b), (l_gpu, l_cpu)
    batch = TokenStream(cfg, rcfg.shape, seed=0).batch(0)
    models = {dev: copy.deepcopy(base).to(dev) for dev in ("cpu", cuda)}
    grads = {dev: grads_fn(cfg, rcfg, m, {k: torch.from_numpy(v).to(dev)
                                          for k, v in batch.items()})[0]
             for dev, m in models.items()}
    for k, g in grads["cpu"].items():
        got = grads[cuda][k].cpu()
        if arch == "whisper-small":
            assert float((got - g).abs().max()) <= \
                2.0 ** -8 * float(g.abs().max()), k
        else:
            torch.testing.assert_close(got, g, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL,
                                       msg=lambda m, k=k: f"{k}: {m}")
    opt = make_optimizer(rcfg)
    for dev, m in models.items():
        p = dict(m.named_parameters())
        opt.update({k: g.to(dev) for k, g in grads["cpu"].items()},
                   opt.init(p), p, 0)
    for (k, a), b in zip(models[cuda].named_parameters(),
                         models["cpu"].parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                   atol=UPDATE_ATOL,
                                   msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_train_plans_on_card_match_bincount(cuda, remat):
    """Every plan of a phi3.5 train step on the card (the forward's and,
    under remat, the recompute's) equals ``count_backend="jnp"``'s, and
    the kernel runs once per MoE layer, twice under remat."""
    from repro_torch.moe import moe_layer
    cfg = smoke_model(ARCHS["phi3.5-moe-42b-a6.6b"])
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", 64, 4, "train"),
                     compute_dtype="float32", remat=remat)
    base = M.init(cfg, 0, device="cpu")
    calls = []
    real = moe_layer.plan_buckets_sorted

    def recording(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, out))
        return out
    moe_layer.plan_buckets_sorted = recording
    before = bucket_count_kernel.launches
    try:
        _train_on(cfg, rcfg, base, cuda, 1)
    finally:
        moe_layer.plan_buckets_sorted = real
    moe_layers = sum(s.mlp == "moe" for s in cfg.full_pattern)
    assert bucket_count_kernel.launches - before == len(calls) == \
        moe_layers * (1 if remat == "none" else 2)
    for args, (plan, order) in calls:
        plan_j, order_j = plan_buckets_sorted(*args, count_backend="jnp")
        assert torch.equal(order, order_j)
        for f in ("owner", "position", "counts", "kept", "dropped"):
            assert torch.equal(getattr(plan, f), getattr(plan_j, f)), f
