"""The five port examples (``examples_torch/``) against the reference's
(``examples/``), on the CPU.

Each port script runs in a subprocess with ``--device cpu`` in its own
working directory, beside the reference script (``JAX_PLATFORMS=cpu``),
and every number the two print is compared, line for line, except:

* the times (ms), which each run measures for itself;
* the continuous server's product waves, cells, padding and latencies
  (``serve_queries``), which depend on when its submitter and drain
  threads meet; its ticket count is compared;
* PageRank's ``max|err|`` against the float64 oracle, which each package
  computes for its own ranks: each stays within 2e-4.

Both packages run with ``REPRO_AUTOTUNE=off``: the tuner's deterministic
policy, which the two share, so ``auto``'s choices and the restored
service's timing runs do not depend on timing and are compared exactly.
``graph_analytics --distributed`` and ``distributed_pagerank`` run 8
gloo ranks on the CPU against the reference's 8 forced host devices.
``train_lm`` takes 2 steps at 1 x 32 and resumes for a third; its
config's parameter count equals the reference's ``LM100M``.  Each pair of
runs is made once per test run (``tests/_torch_once.py``), the two
scripts at once.
"""
import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from _torch_once import once

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "graph_analytics", "distributed_pagerank",
         "serve_queries", "train_lm")
ERR_BOUND = 2e-4
TIMEOUT_S = 600


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu", "REPRO_AUTOTUNE": "off",
            "REPRO_AUTOTUNE_CACHE": "off", "OMP_NUM_THREADS": "1"}


def _start(script, args, cwd):
    cwd.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([sys.executable, str(script), *args], cwd=cwd,
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, what):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"{what} did not finish in {TIMEOUT_S} s")
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n"
                             f"{out}\n{err[-4000:]}")
    return out


def _pair(tmp_path_factory, name, args=()):
    """(reference stdout, port stdout, port's working directory) of one
    example, computed once per test run."""
    def compute():
        base = tmp_path_factory.mktemp(name)
        ref = _start(ROOT / "examples" / f"{name}.py", args, base / "ref")
        port = _start(ROOT / "examples_torch" / f"{name}.py",
                      ("--device", "cpu", *args), base / "port")
        return (_finish(ref, f"examples/{name}.py"),
                _finish(port, f"examples_torch/{name}.py"), str(base))
    return once(tmp_path_factory, f"example_{name}_{'_'.join(args)}",
                compute, timeout_s=TIMEOUT_S * 2)


_MS = re.compile(r"\s*-?\d+(\.\d+)? ?ms\b")
_ERR = re.compile(r"max\|err\|=(\S+)")


def _lines(out: str, errs: list) -> list:
    """The lines of ``out`` with the times masked and PageRank's error
    taken out (into ``errs``); the port's own lines (the ranks it
    spawned) dropped and its paths read as the reference's."""
    lines = []
    for line in out.splitlines():
        if line.startswith("ranks: "):
            continue
        errs.extend(float(m) for m in _ERR.findall(line))
        line = _ERR.sub("max|err|=<err>", _MS.sub(" <ms>", line))
        line = line.replace("examples_torch/", "examples/")
        line = line.replace(" (see `make trace` for the mixed-tenant "
                            "continuous demo)", "")
        if line.startswith("continuous batching: "):
            line = line.split(" over ")[0]
        lines.append(line.rstrip())
    return lines


def _compare(ref_out, port_out):
    ref_errs, port_errs = [], []
    ref, port = _lines(ref_out, ref_errs), _lines(port_out, port_errs)
    assert port == ref
    assert len(port_errs) == len(ref_errs)
    assert all(e <= ERR_BOUND for e in ref_errs + port_errs), \
        (ref_errs, port_errs)


def test_quickstart(tmp_path_factory):
    ref, port, _ = _pair(tmp_path_factory, "quickstart")
    assert "commit[fused ]" in port and "BFS    rounds=" in port
    _compare(ref, port)


@pytest.mark.parametrize("part", ["single_shard", "distributed"])
def test_graph_analytics(tmp_path_factory, part):
    """The six case studies on one shard, then their ``distributed_*``
    forms on 8 gloo CPU ranks against 8 forced host devices."""
    ref, port, _ = _pair(tmp_path_factory, "graph_analytics",
                         ("--distributed",))
    head = "8-shard run_distributed harness"
    assert "ranks: 8 gloo processes on cpu (world size 8)" in port
    i = 1 if part == "distributed" else 0
    ref_part, port_part = ref.split(head)[i], port.split(head)[i]
    _compare(ref_part, port_part)
    if part == "distributed":
        assert port_part.count("delivered_all=True") == 6
        assert "valid=True" in port_part


def test_distributed_pagerank(tmp_path_factory):
    """8 gloo CPU ranks against 8 forced host devices; the port imports
    both entry points from ``repro_torch.core.engine``."""
    ref, port, _ = _pair(tmp_path_factory, "distributed_pagerank")
    assert "ranks: 8 gloo processes on cpu (world size 8)" in port
    assert "correct=True" in port
    _compare(ref, port)


@pytest.mark.parametrize("part", ["lines", "trace"])
def test_serve_queries(tmp_path_factory, part):
    """Every line, and the trace each script writes to its working
    directory validates under both packages' validators."""
    ref, port, base = _pair(tmp_path_factory, "serve_queries")
    if part == "lines":
        for want in ("cache_hits=1", "restarts=1", "7 async tickets"):
            assert want in port
        _compare(ref, port)
        return
    from repro.obs.trace import validate_trace as ref_validate
    from repro_torch.obs.trace import validate_trace
    docs = {}
    for side in ("ref", "port"):
        docs[side] = json.loads((pathlib.Path(base) / side
                                 / "TRACE_example.json").read_text())
    assert validate_trace(docs["port"]) == []
    assert ref_validate(docs["port"]) == []
    names = {side: sorted({e["name"] for e in doc["traceEvents"]})
             for side, doc in docs.items()}
    assert names["port"] == names["ref"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm(tmp_path):
    """lm-100m's fields and parameter count equal the reference's; 2
    steps at 1 x 32 on the CPU, then a run on the same checkpoint
    directory resumes from step 2 and takes the third."""
    ref = _load(ROOT / "examples" / "train_lm.py", "ref_train_lm")
    port = _load(ROOT / "examples_torch" / "train_lm.py", "port_train_lm")
    assert dataclasses.asdict(port.LM100M) == dataclasses.asdict(ref.LM100M)
    assert port.LM100M.param_count() == ref.LM100M.param_count()
    ckpt = tmp_path / "ckpt"
    try:
        outs = []
        for steps in (2, 3):
            proc = _start(ROOT / "examples_torch" / "train_lm.py",
                          ("--device", "cpu", "--steps", str(steps),
                           "--batch", "1", "--seq", "32", "--ckpt-dir",
                           str(ckpt)), tmp_path)
            outs.append(_finish(proc, f"train_lm.py --steps {steps}"))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)   # 0.9 GB a checkpoint
    first, second = outs
    want = f"params: {ref.LM100M.param_count() / 1e6:.1f}M"
    assert first.splitlines()[0] == want
    assert "resumed" not in first and "[launch] done: 2 steps" in first
    assert "[launch] resumed from step 2" in second
    assert "[launch] done: 3 steps" in second
    losses = [float(m) for m in re.findall(r"'loss': ([-\d.e+naninf]+)",
                                           first + second)]
    assert losses and all(math.isfinite(x) for x in losses)


@pytest.mark.parametrize("name", NAMES)
def test_example_defaults_to_cuda(name):
    """Without ``--device`` each script asks for the card, and raises
    here before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mod = _load(ROOT / "examples_torch" / f"{name}.py", f"port_{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
