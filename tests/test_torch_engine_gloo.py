"""The engine's collectives over gloo ranks, the spawner of the examples
and the concurrent kernel build.

* ``_all_to_all``, ``_psum`` and ``_all_gather_rows`` of
  ``repro_torch.core.engine`` on 2 gloo ranks, on CPU tensors here and on
  CUDA tensors of ranks that share ``cuda:0`` (marked ``cuda``; skipped
  without a card), equal to what each collective means (int32, float32
  and bool rows, as the engine sends them).
* ``repro_torch.launch.mesh.spawn_ranks`` runs a function on every rank
  and raises when one rank raises.
* ``repro_torch.core.engine`` re-exports ``distributed_bfs`` and
  ``distributed_pagerank`` (the reference's import path), and
  ``distributed_bfs`` imported from there runs on 2 gloo CPU ranks.
* ``kernels._build.build`` called from two processes at once compiles
  each source once, with ``nvcc`` stubbed by a script that writes its
  output slowly: no library is read half written, and no temporary file
  is left.
"""
import os
import pathlib
import stat
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.launch.mesh import spawn_ranks

WORLD = 2
ROWS = 3                       # rows a rank sends to each peer


def _mine(rank, dtype, device):
    x = torch.arange(WORLD * ROWS, device=device).reshape(WORLD, ROWS)
    x = x * 10 + rank
    return (x % 3 == 0) if dtype == torch.bool else x.to(dtype)


def _collectives(mesh, out_dir):
    from repro_torch.core import engine as E
    out = {}
    for dtype in (torch.int32, torch.float32, torch.bool):
        x = _mine(mesh.rank, dtype, mesh.device)
        name = str(dtype).split(".")[-1]
        out[f"a2a_{name}"] = E._all_to_all(x, mesh).cpu().numpy()
        out[f"gather_{name}"] = E._all_gather_rows(x, mesh).cpu().numpy()
        if dtype != torch.bool:
            out[f"psum_{name}"] = E._psum(x, mesh).cpu().numpy()
    np.savez(pathlib.Path(out_dir) / f"rank{mesh.rank}.npz", **out)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda:0", marks=[pytest.mark.cuda,
                                         pytest.mark.skipif(
        not torch.cuda.is_available(), reason="needs a CUDA device")])])
def test_engine_collectives_over_gloo(device, tmp_path):
    spawn_ranks(_collectives, WORLD, device=device, args=(str(tmp_path),),
                timeout_s=300)
    for rank in range(WORLD):
        got = dict(np.load(tmp_path / f"rank{rank}.npz"))
        for dtype in (torch.int32, torch.float32, torch.bool):
            name = str(dtype).split(".")[-1]
            every = [_mine(r, dtype, "cpu").numpy() for r in range(WORLD)]
            np.testing.assert_array_equal(
                got[f"a2a_{name}"], np.stack([e[rank] for e in every]))
            np.testing.assert_array_equal(got[f"gather_{name}"],
                                          np.concatenate(every))
            if dtype != torch.bool:
                np.testing.assert_array_equal(got[f"psum_{name}"],
                                              sum(every))
            assert got[f"a2a_{name}"].dtype == every[0].dtype


def _fails_on_rank_1(mesh):
    """Rank 1 raises; the others wait until ``spawn_ranks`` kills them (a
    collective here would fail on them too, and which rank's error the
    spawner reports first would be a race)."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    time.sleep(240)


def test_spawn_ranks_raises_when_a_rank_fails():
    with pytest.raises(Exception, match="rank 1 fails"):
        spawn_ranks(_fails_on_rank_1, WORLD, device="cpu", timeout_s=300)


def _bfs_through_engine(mesh, out_dir):
    from repro_torch.core.engine import distributed_bfs
    from repro_torch.graphs.generators import kronecker
    g = kronecker(7, 8, seed=2, device="cpu")
    dist, rounds = distributed_bfs(mesh, g, 0, capacity=64)
    if mesh.rank == 0:
        np.save(pathlib.Path(out_dir) / "dist.npy", dist.numpy())


def test_engine_reexports_distributed_entry_points(tmp_path):
    from repro_torch.core import engine
    from repro_torch.graphs.algorithms import bfs, pagerank
    assert engine.distributed_bfs is bfs.distributed_bfs
    assert engine.distributed_pagerank is pagerank.distributed_pagerank
    with pytest.raises(AttributeError):
        engine.distributed_sssp_missing
    spawn_ranks(_bfs_through_engine, WORLD, device="cpu",
                args=(str(tmp_path),), timeout_s=300)
    from repro_torch.graphs.generators import kronecker
    g = kronecker(7, 8, seed=2, device="cpu")
    np.testing.assert_array_equal(np.load(tmp_path / "dist.npy"),
                                  bfs.bfs_reference(g, 0))


FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import os, sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(os.environ["FAKE_NVCC_LOG"], "a") as fh:
        fh.write(os.path.basename(sys.argv[-1]) + "\\n")
    with open(out, "wb") as fh:
        fh.write(b"half")
        fh.flush()
        time.sleep(0.5)
        fh.write(b" whole")
    print("ptxas info: 0 bytes spill stores, 0 bytes spill loads")
    """)


def _build_with_fake_nvcc(build_dir, nvcc, log, names, out):
    os.environ["FAKE_NVCC_LOG"] = log
    from repro_torch.kernels import _build
    _build.BUILD_DIR = pathlib.Path(build_dir)
    _build._nvcc = lambda: nvcc
    _build.build(names)
    # what a process finds once its build returns: whole libraries and
    # their reports
    with open(out, "w") as fh:
        for name in names:
            target = _build._target(name)
            fh.write(f"{target.read_bytes().decode()}|"
                     f"{target.with_suffix('.ptxas.txt').exists()}\n")


def test_concurrent_builds_compile_each_source_once(tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "nvcc.log"
    names = ("coalesce", "coarse_commit")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_build_with_fake_nvcc, args=(
        str(tmp_path / "build"), str(nvcc), str(log), names,
        str(tmp_path / f"seen{i}.txt"))) for i in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    assert [p.exitcode for p in procs] == [0, 0]
    assert sorted(log.read_text().split()) == sorted(f"{n}.cu"
                                                     for n in names)
    for i in range(2):
        assert (tmp_path / f"seen{i}.txt").read_text().splitlines() == \
            ["half whole|True"] * len(names)
    left = [p.name for p in (tmp_path / "build").iterdir()
            if p.name.endswith(".tmp")]
    assert left == []
