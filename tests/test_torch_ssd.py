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
