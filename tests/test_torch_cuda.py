"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: bit-identical state and conflict count; float ``add`` within
rtol 2e-4 / atol 1e-6 (atomics add in an order that changes run to run).
"""
import pytest
import torch

from repro_torch.core.commit import BACKENDS, CommitSpec, commit
from repro_torch.core.messages import make_messages
from repro_torch.kernels import ref
from repro_torch.kernels.coarse_commit import coarse_commit_kernel
from repro_torch.kernels.fused_wave import fused_route_commit_kernel

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
