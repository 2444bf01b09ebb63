"""``repro_torch.obs.commit_profile`` without a card: it imports, refuses
to run, reads a ptxas report, and finds the largest BFS round's batch on
the CPU as the ``pallas`` tier hands it to its kernel."""
import os
import pathlib
import subprocess
import sys

import torch

from repro_torch.graphs.algorithms.bfs import bfs
from repro_torch.graphs.generators import kronecker
from repro_torch.obs import commit_profile

ROOT = pathlib.Path(__file__).resolve().parents[1]

REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3aam9fill_rankEPii' for 'sm_90a'
ptxas info    : Function properties for _ZN3aam9fill_rankEPii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 10 registers, 364 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'
ptxas info    : Function properties for _Z1kv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, 1024 bytes smem, 360 bytes cmem[0]
"""


def test_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert commit_profile.main() == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_module_exits_nonzero_without_a_card():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m",
                          "repro_torch.obs.commit_profile"], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 1
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_ptxas_lines_pair_each_kernel_with_its_resources():
    lines = commit_profile.ptxas_lines(REPORT)
    assert len(lines) == 2
    (first, used0), (second, used1) = lines
    assert "fill_rank" in first
    assert "Used 10 registers" in used0 and "0 bytes spill loads" in used0
    assert "k" in second
    assert "Used 64 registers, 1024 bytes smem" in used1
    assert "4 bytes spill loads" in used1


def test_largest_bfs_round_is_the_round_with_most_valid_messages():
    g = kronecker(8, 8, seed=3, device="cpu")
    src = int(torch.argmax(g.degrees))
    state, idx, val = commit_profile.largest_bfs_round(g, src)
    dist = bfs(g, src).dist
    # the round that reads level l sends one message per out-edge of the
    # vertices at distance l
    levels = [int(g.degrees[dist == lvl].sum())
              for lvl in range(int(dist[dist < 2 ** 30].max()) + 1)]
    assert int((idx >= 0).sum()) == max(levels)
    assert idx.dtype == torch.int32 and val.dtype == torch.int32
    assert idx.shape == (g.num_edges,) and state.shape == (g.num_vertices,)
    level = levels.index(max(levels))
    assert torch.equal(idx >= 0, (dist == level)[g.src.long()])
    assert torch.equal(state, torch.where(dist <= level, dist, 2 ** 30))
