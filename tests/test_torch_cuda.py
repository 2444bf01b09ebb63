"""The port's CUDA kernels against their plain versions, the wave engine
on the card against the engine on the CPU, and the Mamba2 serving path on
its kernel path against its plain path.

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
