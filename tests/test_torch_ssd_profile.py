"""``repro_torch.obs.ssd_profile`` without a card: it imports, refuses to
run, counts bytes and FLOPs as ``chip_smoke.py::ssd_bound`` does, draws
its inputs as phase 7 does, and its einsum batch computes the SSD
intra-chunk term."""
import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels.ref import ssd_chunk_ref
from repro_torch.obs import ssd_profile

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ssd_profile.main() == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_module_exits_nonzero_without_a_card():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.ssd_profile"],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 1
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("label", sorted(ssd_profile.KERNEL_CASES))
def test_work_is_what_chip_smoke_bounds(label):
    """(b)-(f); (a) moves (b)'s bytes."""
    smoke = _chip_smoke()
    L, n, p, dt = ssd_profile.KERNEL_CASES[label]
    elem = ssd_profile.ELEM_BYTES[dt]
    assert elem == getattr(torch, dt).itemsize
    nbytes, flops = ssd_profile.work(ssd_profile.G, L, n, p, elem)
    bound, by, byte_ms, flop_ms = smoke.ssd_bound(ssd_profile.G, L, n, p,
                                                  elem)
    assert nbytes / smoke.HBM_BYTES_PER_S * 1e3 == pytest.approx(byte_ms,
                                                                  rel=1e-12)
    assert flops / ssd_profile.FLOP_PER_S[dt] * 1e3 == pytest.approx(
        flop_ms, rel=1e-12)
    assert ssd_profile.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    assert ssd_profile.FLOP_PER_S == {"float32": smoke.F32_FLOP_PER_S,
                                      "bfloat16": smoke.BF16_FLOP_PER_S}
    line = ssd_profile.rates(label, 1.0, nbytes, flops, dt)
    assert f"bound {bound:.4f} ms" in line
    # at layer 0's shapes, bytes bound the kernel
    if label.startswith("(b)"):
        assert by == "bytes" and nbytes == 6144 * 197120


def test_inputs_fall_to_the_depth_of_a_prefill():
    gen = torch.Generator().manual_seed(0)
    C, B, x, a = ssd_profile.inputs(64, 128, 16, 8, torch.bfloat16, gen,
                                    device="cpu")
    assert C.dtype == B.dtype == x.dtype == torch.bfloat16
    assert a.dtype == torch.float32
    assert C.shape == B.shape == (64, 128, 16) and x.shape == (64, 128, 8)
    assert (a <= 0).all()
    depth = torch.cumsum(a.double(), 1)[:, -1]
    assert -300 < float(depth.mean()) < -200


def test_einsum_batch_computes_the_intra_chunk_term():
    gen = torch.Generator().manual_seed(1)
    args = ssd_profile.inputs(6, 32, 16, 8, torch.float32, gen, device="cpu")
    torch.testing.assert_close(ssd_profile.einsum_path(*args),
                               ssd_chunk_ref(*args), atol=1e-4, rtol=1e-3)
