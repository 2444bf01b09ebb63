"""SSD intra-chunk block: the quadratic term of the Mamba2 mixer.

:func:`ssd_chunk_kernel` computes, for each of G (batch x chunk x head)
cells, ``y[t] = sum_{s<=t} (C_t.B_s) exp(cs_t - cs_s) x_s`` with
``cs = cumsum(a)``, accumulated in f32 and returned in ``x.dtype``.  It is
called by :func:`repro_torch.models.ssm.ssm_apply` when ``use_pallas``.

A tensor on the CPU goes to the plain version
(:func:`repro_torch.kernels.ref.ssd_chunk_ref`); a CUDA tensor goes to the
hand-written kernel ``csrc/ssd_chunk.cu`` (tensor cores in 3xTF32, a
persistent grid streaming C and B through shared memory, the L x L matrix
in registers), which launches on the current stream and does not
synchronise.  Both take ``cumsum(a)`` in f64 and round it to f32, so they
form the same decays.  The kernel takes C, B and x of one dtype, f32 or
bf16, ``a`` in f32, chunks of 1 to :data:`MAX_L` rows and cells whose
staged columns of C and B, x and cumsum fit in the shared memory the card
lets one CTA opt in to (the source checks that and the wrapper raises); it
has no backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunk_ref

MAX_L = 128                    # csrc/ssd_chunk.cu: 8 blocks of 16 rows
NO_ROOM = -1                   # csrc/ssd_chunk.cu: kErrNoRoom
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_chunk_kernel(C, B, x, a):
    """C, B: [G, L, N]; x: [G, L, P]; a: [G, L].  Returns y [G, L, P]."""
    if C.dim() != 3 or B.shape != C.shape or x.dim() != 3 \
            or x.shape[:2] != C.shape[:2] or a.shape != C.shape[:2]:
        raise ValueError(f"shapes C {tuple(C.shape)}, B {tuple(B.shape)}, "
                         f"x {tuple(x.shape)}, a {tuple(a.shape)} are not "
                         "[G, L, N], [G, L, N], [G, L, P], [G, L]")
    if C.device.type == "cpu":
        return ssd_chunk_ref(C, B, x, a)
    if C.device.type != "cuda":
        raise ValueError(f"no kernel for device {C.device}")
    for name, t in (("B", B), ("x", x), ("a", a)):
        if t.device != C.device:
            raise ValueError(f"{name} on {t.device}, C on {C.device}")
    if C.dtype not in _DTYPES or B.dtype != C.dtype or x.dtype != C.dtype:
        raise TypeError(f"C, B, x must share one dtype of float32/bfloat16, "
                        f"got {C.dtype}, {B.dtype}, {x.dtype}")
    if a.dtype != torch.float32:
        raise TypeError(f"a must be float32, got {a.dtype}")
    if not all(t.is_contiguous() for t in (C, B, x, a)):
        raise ValueError("C, B, x and a must be contiguous")
    g, L, n = C.shape
    p = x.shape[2]
    if not 1 <= L <= MAX_L:
        raise ValueError(f"chunk length {L} outside the kernel's 1..{MAX_L}")
    if n < 1 or p < 1 or g >= 2 ** 31:
        raise ValueError(f"N={n}, P={p}, G={g}: the kernel takes N, P >= 1 "
                         "and G < 2**31")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (C, B, x, a)):
        raise NotImplementedError("the SSD kernel has no backward yet "
                                  "(ROADMAP Queue 1 item 9, training)")
    y = torch.empty_like(x)
    if g == 0:
        return y
    lib = _build.load("ssd_chunk")
    err = lib.aam_ssd_chunk(
        y.data_ptr(), C.data_ptr(), B.data_ptr(), x.data_ptr(), a.data_ptr(),
        g, L, n, p, _DTYPES[C.dtype],
        torch.cuda.current_stream(C.device).cuda_stream)
    if err == NO_ROOM:
        raise ValueError(f"L={L}, P={p}: a cell needs more shared memory "
                         f"than a CTA may opt in to on {C.device}")
    _build.check(lib, err, "ssd_chunk")
    ssd_chunk_kernel.launches += 1
    return y


ssd_chunk_kernel.launches = 0
