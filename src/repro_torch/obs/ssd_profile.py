"""Where the SSD chunk kernel's time goes: device ms per launch on batches
that each take one cost away, on one card.

    PYTHONPATH=src python3 -m repro_torch.obs.ssd_profile

Every batch holds G = 6,144 random cells (the cells of one layer of a
mamba2-780m prefill of 8 x 2048 tokens), C, B and x normal, ``a`` drawn
so that ``cumsum(a)`` falls to about -250 over a chunk, as
``chip_smoke.py`` phase 7 draws it.  The batches:

(a) a pass of PyTorch's own streaming kernels over (b)'s inputs that
    reads C, B, x and ``a`` once and writes a y-sized output (three sums
    and a copy): the byte rate this card reaches on the kernel's bytes;
(b) the kernel at layer 0's shapes, L 128, N 128, P 64, f32;
(c) the same in bf16 (half the bytes, the same products);
(d) N = 16: the C B^T product shrinks 8x;
(e) P = 16: the S x product shrinks 4x;
(f) L = 64: half the rows, a quarter of the L x L matrix;
(g) the mixer's einsum path on (b)'s inputs (``models/ssm.py``: two
    einsums and a mask), for scale: it is not one PyTorch call.

Beside each time: the bytes the work must move (each input read once, the
output written once) and its causal FLOPs (L(L+1)/2 (N + P) FMAs a cell),
as rates and as shares of the card's HBM rate and of the peak rate of
the inputs' type (f32 FMA, or bf16 tensor cores), the formulas of
``chip_smoke.py::ssd_bound``.  Then the ``-Xptxas -v`` report of
``csrc/ssd_chunk.cu``: registers, shared memory and spills of each kernel
instance.  Device ms are taken as :func:`repro_torch.obs.timing.device_ms`
says.  Needs a CUDA device; about a minute.
"""
from __future__ import annotations

import subprocess
import sys

from repro_torch.launch.roofline import F32_FLOPS as F32_FLOP_PER_S
from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_PER_S
from repro_torch.launch.roofline import PEAK_FLOPS as BF16_FLOP_PER_S
from repro_torch.obs.commit_profile import ptxas_lines
from repro_torch.obs.timing import REPS, WINDOWS, device_ms

G = 6144                           # cells of one mamba2-780m prefill layer
FLOP_PER_S = {"float32": F32_FLOP_PER_S, "bfloat16": BF16_FLOP_PER_S}
DEPTH = -250.0                     # cumsum(a) at the end of a chunk, about
# label -> (L, N, P, dtype name) of the kernel's batches
KERNEL_CASES = {
    "(b) L 128, N 128, P 64, f32": (128, 128, 64, "float32"),
    "(c) L 128, N 128, P 64, bf16": (128, 128, 64, "bfloat16"),
    "(d) L 128, N 16, P 64, f32": (128, 16, 64, "float32"),
    "(e) L 128, N 128, P 16, f32": (128, 128, 16, "float32"),
    "(f) L 64, N 128, P 64, f32": (64, 128, 64, "float32"),
}
ELEM_BYTES = {"float32": 4, "bfloat16": 2}


def work(g: int, L: int, n: int, p: int, elem: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one launch: C, B [g, L, n] and x, y [g, L, p] of
    ``elem`` bytes and ``a`` [g, L] f32, each moved once; the causal
    products, L(L+1)/2 (n + p) FMAs of 2 FLOPs a cell."""
    return (g * ((2 * L * n + 2 * L * p) * elem + 4 * L),
            g * L * (L + 1) // 2 * (n + p) * 2)


def inputs(g, L, n, p, dtype, gen, device="cuda"):
    """C, B, x normal in ``dtype``; ``a`` f32 with cumsum(a) falling to
    about DEPTH over the chunk."""
    import torch
    C, B = (torch.randn(g, L, n, generator=gen, device=device)
            for _ in range(2))
    x = torch.randn(g, L, p, generator=gen, device=device)
    a = torch.rand(g, L, generator=gen, device=device) * (2 * DEPTH / L)
    return [t.to(dtype) for t in (C, B, x)] + [a]


def einsum_path(C, B, x, a):
    """The mixer's plain intra-chunk term (``models/ssm.py``), batched
    over cells: C B^T, the segment-sum mask, then the product with x."""
    import torch
    from repro_torch.models.ssm import _segsum_mask
    gram = torch.einsum("gln,gsn->gls", C, B)
    return torch.einsum("gls,gsp->glp", gram * _segsum_mask(a), x)


def rates(label, ms, nbytes, flops, dtype="float32") -> str:
    """One line: the time, the byte and FLOP rates, each as a share of
    the card's (FLOPs at the peak of ``dtype``), and the bound (the larger
    of the two times)."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / FLOP_PER_S[dtype] * 1e3
    peak = "f32 FMA" if dtype == "float32" else f"{dtype} peak"
    return (f"{label}: {ms:.4f} ms  {nbytes / ms / 1e9:.3f} TB/s "
            f"({byte_ms / ms:.3f} of HBM)  {flops / ms / 1e9:.2f} TFLOP/s "
            f"({flop_ms / ms:.3f} of {peak})  bound "
            f"{max(byte_ms, flop_ms):.4f} ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"ssd_profile: G={G} cells, cumsum(a) down to about {DEPTH}; "
          f"device ms per launch, {REPS} launches back to back, median of "
          f"{WINDOWS} windows; bytes and FLOPs as chip_smoke.py::ssd_bound "
          f"counts them")
    gen = torch.Generator(device="cuda").manual_seed(0)
    L, n, p, _ = KERNEL_CASES["(b) L 128, N 128, P 64, f32"]
    C, B, x, a = inputs(G, L, n, p, torch.float32, gen)
    y = torch.empty_like(x)
    nbytes, flops = work(G, L, n, p, 4)
    ms = device_ms(lambda: (C.sum(), B.sum(), a.sum(), y.copy_(x)))
    print(rates("(a) read C, B, a, copy x to y (four PyTorch launches), "
                "f32", ms, nbytes, 0))
    for label, (L, n, p, dt) in KERNEL_CASES.items():
        args = inputs(G, L, n, p, getattr(torch, dt), gen)
        ms = device_ms(lambda: ssd_chunk_kernel(*args))
        print(rates(label, ms, *work(G, L, n, p, ELEM_BYTES[dt]), dt))
        del args
    ms = device_ms(lambda: einsum_path(C, B, x, a))
    print(rates("(g) two einsums and a mask (models/ssm.py) on (b)'s "
                "inputs, f32", ms, nbytes, flops))
    print("ptxas, csrc/ssd_chunk.cu:")
    for kernel, used in ptxas_lines(_build.ptxas_report("ssd_chunk")):
        print(f"  {kernel}: {used}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
