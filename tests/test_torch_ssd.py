"""The port's SSD intra-chunk block against the reference's.

On the CPU, :func:`repro_torch.kernels.ssd_chunk.ssd_chunk_kernel` runs
its plain version :func:`repro_torch.kernels.ref.ssd_chunk_ref`; both are
held against ``jax.vmap(repro.kernels.ref.ssd_chunk_ref)`` and against the
reference's Pallas kernel in interpret mode (``repro.kernels.ops``), on
the same numpy inputs.  Tolerances are the reference's own
(``tests/test_kernels.py``): f32 atol 1e-4; bf16 inputs atol 0.15,
rtol 0.1.  The CUDA kernel is held against the same plain version on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels.ref import ssd_chunk_ref
from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel

# the shapes of the reference's test_ssd_chunk, then chunk lengths the
# mixer reaches when S has no divisor near the chunk (S = 131 -> L = 1,
# S = 200 -> L = 100)
SHAPES = [(2, 32, 8, 16), (4, 64, 16, 64), (1, 128, 64, 32),
          (3, 1, 16, 16), (3, 7, 16, 16), (2, 100, 16, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each
    (a worker's default of one thread per core makes the port's small
    ops several times slower under the suite's load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(g, L, n, p, seed, decay=0.1):
    rng = np.random.default_rng(seed)
    C = rng.normal(size=(g, L, n)).astype(np.float32)
    B = rng.normal(size=(g, L, n)).astype(np.float32)
    x = rng.normal(size=(g, L, p)).astype(np.float32)
    a = (-np.abs(rng.normal(size=(g, L))) * decay).astype(np.float32)
    return C, B, x, a


def _torch(*arrays, dtype=torch.float32):
    *rest, a = arrays
    return [torch.from_numpy(t).to(dtype) for t in rest] + \
        [torch.from_numpy(a)]


@pytest.mark.parametrize("g,L,n,p", SHAPES)
def test_ssd_chunk_matches_reference(g, L, n, p):
    arrays = _inputs(g, L, n, p, seed=L * 1000 + n)
    expected = np.asarray(jax.vmap(jref.ssd_chunk_ref)(*map(jnp.asarray,
                                                             arrays)))
    pallas = np.asarray(jops.ssd_chunk(*map(jnp.asarray, arrays)))
    for fn in (ssd_chunk_ref, ssd_chunk_kernel):
        y = fn(*_torch(*arrays))
        assert y.dtype == torch.float32 and y.shape == (g, L, p)
        np.testing.assert_allclose(y.numpy(), expected, atol=1e-4)
        np.testing.assert_allclose(y.numpy(), pallas, atol=1e-4)


@pytest.mark.parametrize("g,L,n,p", [(2, 32, 8, 16), (3, 7, 16, 16)])
def test_ssd_chunk_bf16_inputs(g, L, n, p):
    """bf16 C, B, x and f32 a: f32 accumulation, a bf16 result."""
    arrays = _inputs(g, L, n, p, seed=7 + L)
    *cbx, a = arrays
    cbx16 = [jnp.asarray(t, jnp.bfloat16) for t in cbx]
    expected = np.asarray(jax.vmap(jref.ssd_chunk_ref)(
        *[t.astype(jnp.float32) for t in cbx16], jnp.asarray(a)))
    pallas = np.asarray(jops.ssd_chunk(*cbx16, jnp.asarray(a)), np.float32)
    y = ssd_chunk_kernel(*_torch(*arrays, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16
    for want in (expected, pallas):
        np.testing.assert_allclose(y.float().numpy(), want, atol=0.15,
                                   rtol=0.1)


@pytest.mark.parametrize("L", [1, 64, 128])
def test_ssd_chunk_deep_decay_stays_finite(L):
    """cumsum(a) down to about -250, as in a full-width prefill: the
    decays are exponentials of differences and the masked entries, whose
    exp overflows, never enter the sum.  Tolerance rtol 1e-3: at |cs| near
    250 an f32 ulp is 1.5e-5, and the two packages sum up to 128 steps of
    cs in different orders, so cs_t - cs_s, and with it each decay, differs
    by up to about 1e-3 relative between them."""
    arrays = _inputs(4, L, 16, 16, seed=L, decay=500.0 / L)
    assert np.cumsum(arrays[3], axis=1).min() < -200
    expected = np.asarray(jax.vmap(jref.ssd_chunk_ref)(*map(jnp.asarray,
                                                             arrays)))
    y = ssd_chunk_kernel(*_torch(*arrays)).numpy()
    assert np.isfinite(y).all()
    np.testing.assert_allclose(y, expected, atol=1e-4, rtol=1e-3)


def test_ssd_chunk_rejects_mismatched_shapes():
    C, B, x, a = _torch(*_inputs(2, 8, 4, 4, seed=0))
    with pytest.raises(ValueError, match="shapes"):
        ssd_chunk_kernel(C, B[:, :4], x, a)
    with pytest.raises(ValueError, match="shapes"):
        ssd_chunk_kernel(C, B, x, a[:1])


# --- the CUDA kernel's arithmetic, emulated on the CPU ----------------------
#
# csrc/ssd_chunk.cu forms both products on the tensor cores in 3xTF32: each
# f32 operand v is split into big = v rounded to TF32 (10 mantissa bits,
# nearest, ties away from zero: cvt.rna.tf32.f32) and small = v - big, of
# which the MMA reads the top 10 mantissa bits (it ignores the low 13 bits
# of a TF32 operand); the product sums small.big + big.small + big.big in
# f32 and drops small.small.  Products of TF32 values are exact in f32, so
# f32 matmuls of the parts emulate the MMAs up to the order of the sums.


def _tf32_rna(t):
    """Round f32 to TF32, nearest with ties away from zero."""
    u = t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def _tf32_trunc(t):
    """What the tensor core reads of an f32 operand: the top 10 mantissa
    bits."""
    return (t.view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_product(a, b, passes, small=_tf32_trunc):
    if passes == 1:
        return torch.bmm(_tf32_rna(a), _tf32_rna(b))
    a_big, b_big = _tf32_rna(a), _tf32_rna(b)
    a_small, b_small = small(a - a_big), small(b - b_big)
    return (torch.bmm(a_small, b_big) + torch.bmm(a_big, b_small)
            + torch.bmm(a_big, b_big))


def _ssd_in_tf32(C, B, x, a, passes, small=_tf32_trunc):
    """The kernel's sequence: S = C B^T, the decays, then S x, each product
    in ``passes`` TF32 passes (3: 3xTF32, 1: one TF32 product)."""
    L = a.shape[-1]
    cs = torch.cumsum(a.double(), -1).float()
    tri = torch.ones(L, L, dtype=torch.bool).tril()
    decay = torch.where(tri, torch.exp(cs[:, :, None] - cs[:, None, :]), 0.0)
    S = _tf32_product(C, B.transpose(1, 2), passes, small) * decay
    return _tf32_product(S, x, passes, small)


def test_tf32_rounding_keeps_ten_mantissa_bits_ties_away():
    one = 1.0 + 2.0 ** -10
    v = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e38,
                      -0.0, 2.0 ** -130], dtype=torch.float32)
    got = _tf32_rna(v)
    want = torch.tensor([1.0, one, one, -one, 1.0, 3.0e38, -0.0, 2.0 ** -130],
                        dtype=torch.float32)
    assert torch.equal(got.view(torch.int32) & 0x1FFF,
                       torch.zeros(8, dtype=torch.int32))
    torch.testing.assert_close(got, want, rtol=2.0 ** -11, atol=0)
    assert float(got[1]) == one and float(got[4]) == 1.0   # tie away, below
    assert float(got[2]) == one and float(_tf32_trunc(v[2:3])) == 1.0


@pytest.mark.parametrize("small", [_tf32_trunc, _tf32_rna],
                         ids=["small-as-the-mma-reads-it", "small-rounded"])
def test_three_tf32_passes_keep_the_f32_tolerance(small):
    """At layer 0's widths (L 128, N 128, P 64) with cumsum(a) down to
    about -250, 3xTF32 stays within the kernel's f32 tolerance (atol 1e-4,
    rtol 1e-3) of the plain version and of the reference; one TF32 pass
    misses it by far (about 80x on these inputs)."""
    rng = np.random.default_rng(19)
    g, L, n, p = 8, 128, 128, 64
    C, B, x, a = _torch(*_inputs(g, L, n, p, seed=19))
    a = torch.from_numpy((-rng.uniform(size=(g, L)) * 500.0 / L)
                         .astype(np.float32))
    assert float(torch.cumsum(a.double(), 1)[:, -1].mean()) < -200
    plain = ssd_chunk_ref(C, B, x, a)
    reference = torch.from_numpy(np.array(jax.vmap(jref.ssd_chunk_ref)(
        *(jnp.asarray(t.numpy()) for t in (C, B, x, a)))))
    three = _ssd_in_tf32(C, B, x, a, 3, small)
    one = _ssd_in_tf32(C, B, x, a, 1)
    for want in (plain, reference):
        torch.testing.assert_close(three, want, atol=1e-4, rtol=1e-3)
        excess = (one - want).abs() / (1e-4 + 1e-3 * want.abs())
        assert float(excess.max()) > 10.0
