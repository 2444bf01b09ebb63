"""The port stands alone and keeps to its device rule.

* Every module of ``repro_torch``, ``chip_smoke`` and the examples of
  ``examples_torch/`` import with JAX made unimportable, and leave no
  module of the reference package loaded.
* Entry points that build tensors default to ``device="cuda"`` and raise
  when no card is present, rather than running on the CPU unasked.
"""
import os
import pathlib
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_port_imports_without_jax_or_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        # the examples, imported as modules (their main() does not run)
        import importlib.util, pathlib
        examples = sorted(pathlib.Path("examples_torch").glob("*.py"))
        assert len(examples) == 5, examples
        for path in examples:
            spec = importlib.util.spec_from_file_location(
                "examples_torch_" + path.stem, path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        leaked = sorted(m for m in sys.modules
                        if m == "repro" or m.startswith("repro."))
        assert not leaked, leaked
        assert "jax" not in [m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None]
        for name in ("repro_torch.core.coalescing", "repro_torch.core.engine",
                     "repro_torch.core.tree", "repro_torch.kernels.coalesce",
                     "repro_torch.launch.mesh", "repro_torch.configs.archs",
                     "repro_torch.kernels.ssd_chunk",
                     "repro_torch.models.ssm", "repro_torch.models.lm",
                     "repro_torch.models.model",
                     "repro_torch.models.attention",
                     "repro_torch.models.encdec",
                     "repro_torch.moe.moe_layer",
                     "repro_torch.serve.serve_step",
                     "repro_torch.launch.serve",
                     "repro_torch.graphs.algorithms.stconn",
                     "repro_torch.graphs.algorithms.coloring",
                     "repro_torch.graphs.algorithms.boruvka",
                     "repro_torch.serve.queries",
                     "repro_torch.serve.graph_service",
                     "repro_torch.serve.product_wave",
                     "repro_torch.serve.continuous",
                     "repro_torch.serve.durable",
                     "repro_torch.checkpoint.checkpointer",
                     "repro_torch.runtime.fault_tolerance",
                     "repro_torch.obs.dump",
                     "repro_torch.data.pipeline",
                     "repro_torch.train.optimizer",
                     "repro_torch.train.train_step",
                     "repro_torch.train.grad_compression",
                     "repro_torch.launch.train",
                     "repro_torch.moe.shmap_moe",
                     "repro_torch.obs.train_profile",
                     "repro_torch.analysis.optrace",
                     "repro_torch.analysis.algebra",
                     "repro_torch.analysis.keyspace",
                     "repro_torch.analysis.waverace",
                     "repro_torch.analysis.lint",
                     "repro_torch.runtime.flops",
                     "repro_torch.runtime.sharding",
                     "repro_torch.train.pipeline",
                     "repro_torch.launch.dryrun",
                     "repro_torch.launch.roofline"):
            assert name in names, name
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 36    # every module was found


def _restore_checkpoint():
    from repro_torch.checkpoint.checkpointer import Checkpointer
    with tempfile.TemporaryDirectory() as d:
        Checkpointer(d).restore({"x": np.zeros(2)})


def _tuner_calls():
    from repro_torch.core.autotune import AutoTuner
    from repro_torch.core.commit import CommitSpec
    knobs = dict(sort=True, stats=False, tile_m=64, block_v=128)
    return [
        lambda: AutoTuner().calibrate(with_pallas=False, **knobs),
        lambda: AutoTuner().race({"atomic": None, "coarse": None}, 64,
                                 **knobs),
        lambda: AutoTuner().policy(CommitSpec(backend="auto"), n=64,
                                   pallas_ok=False),
    ]


def _entry_points():
    from repro_torch import convert
    from repro_torch.obs import dump
    from repro_torch.serve.durable import restore_service
    from repro_torch.serve.graph_service import GraphService
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
    from repro_torch.graphs import csr, generators
    from repro_torch.launch import mesh
    from repro_torch.models import model
    from repro_torch.serve.serve_step import generate
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import train
    from repro_torch.moe import shmap_moe
    from repro_torch.train import train_step
    from repro_torch.analysis import lint
    from repro_torch.train import pipeline
    edges = np.array([0, 1]), np.array([1, 2])
    cfg = smoke_model(ARCHS["mamba2-780m"])
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", 4, 1, "decode"))
    return [
        lambda: generators.kronecker(4, 4),
        lambda: generators.erdos_renyi(16),
        lambda: generators.grid2d(3),
        lambda: generators.preferential(12, 2),
        lambda: generators.bipartite_web(16, 4),
        lambda: csr.from_edges(*edges, 3),
        lambda: convert.to_graph([0, 1, 2, 2], *edges, [1.0, 1.0], 3),
        lambda: convert.to_messages([0], [1]),
        lambda: convert.to_state([0, 0]),
        lambda: convert.to_bucket_plan([0], [0], [1], [True], 0),
        lambda: mesh.make_mesh(),
        lambda: model.init(cfg),
        lambda: model.init_cache(cfg, rcfg, 1, 4),
        lambda: generate(cfg, rcfg, model.init(cfg, device="cpu"),
                         {"tokens": torch.zeros(1, 2, dtype=torch.int32)},
                         max_new_tokens=2),
        lambda: convert.to_lm_params(cfg, {"embed": {}, "blocks": [],
                                           "final_norm": np.ones(2)}),
        lambda: convert.to_graphset([([0, 1, 2, 2], *edges, [1.0, 1.0], 3)]),
        lambda: restore_service(GraphService().snapshot()),
        lambda: GraphService.restore(GraphService().snapshot()),
        _restore_checkpoint,
        lambda: dump.main(["--scale", "3"]),
        lambda: convert.to_encdec_params(
            smoke_model(ARCHS["whisper-small"]),
            {"embed": {}, "enc_pos": np.zeros(2), "encoder": {},
             "decoder": {}, "enc_final_norm": np.ones(2),
             "final_norm": np.ones(2)}),
        lambda: train.main(["--smoke", "--steps", "1"]),
        lambda: train_step.init_train_state(cfg, rcfg),
        lambda: TokenStream(cfg, rcfg.shape).tensors(0),
        lambda: shmap_moe.make_expert_mesh(1, 1),
        lambda: lint.main([]),
        lambda: mesh.make_production_mesh(),
        lambda: mesh.make_host_mesh(),
        lambda: pipeline.pipeline_forward(
            cfg, rcfg, mesh.make_host_mesh(), "data", 1),
        lambda: train_step.make_sharded_train_step(
            cfg, rcfg, None, mesh.make_host_mesh(), train_step.RULES),
    ] + _tuner_calls()


@pytest.mark.parametrize("i", range(33))
def test_entry_points_default_to_cuda(i):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[i]()


def test_entry_points_run_on_cpu_when_asked():
    from repro_torch.graphs.algorithms.bfs import bfs
    from repro_torch.graphs.generators import grid2d
    g = grid2d(4, device="cpu")
    r = bfs(g, 0)
    assert r.dist.device.type == "cpu"
    assert r.dist.tolist() == [i + j for i in range(4) for j in range(4)]


def test_graph_entry_points_follow_the_graph_device():
    """The graph algorithms take their device from the graph or the mesh:
    on a CPU graph every one of them returns CPU tensors."""
    from repro_torch.graphs.algorithms import (bfs, boruvka, coloring,
                                               pagerank, sssp, stconn)
    from repro_torch.graphs.csr import GraphSet
    from repro_torch.graphs.generators import grid2d, random_weights
    from repro_torch.launch.mesh import make_mesh
    g = random_weights(grid2d(4, device="cpu"), seed=1)
    gs = GraphSet([g, random_weights(grid2d(3, device="cpu"), seed=2)])
    mesh = make_mesh(device="cpu")
    outs = [
        stconn.st_connectivity(g, 0, 15)[0],
        stconn.multi_source_stconn(g, [0, 1], [15, 2])[0],
        stconn.batched_over_graphs_stconn(gs, [0, 0], [15, 8]),
        stconn.distributed_stconn(mesh, g, 0, 15)[0],
        stconn.distributed_multi_source_stconn(mesh, g, [0], [15])[0],
        coloring.coloring(g)[0],
        coloring.batched_over_graphs_coloring(gs)[0][1],
        coloring.distributed_coloring(mesh, g)[0],
        boruvka.boruvka(g)[1],
        boruvka.batched_over_graphs_boruvka(gs)[0][1][0],
        boruvka.distributed_boruvka(mesh, g)[0],
        bfs.batched_over_graphs_bfs(gs, [0, 1])[0],
        bfs.distributed_product_bfs(mesh, gs, [[0, 1]])[0],
        sssp.batched_over_graphs_sssp(gs, [0, 1], mesh=mesh)[1],
        sssp.distributed_multi_source_sssp(mesh, g, [0, 3])[0],
        pagerank.multi_source_pagerank(g, [0, 3], iters=2)[0],
        pagerank.batched_over_graphs_pagerank(gs, [0, 1], iters=2)[0],
        pagerank.distributed_multi_source_pagerank(mesh, g, [0], iters=2),
    ]
    for i, out in enumerate(outs):
        assert out.device.type == "cpu", i


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-780m", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "12", "--new-tokens", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[serve] mamba2-780m: generated (2, 4) in ")
    assert lines[1].startswith("[serve] sample: [")


def test_unported_families_raise():
    """Every family is served and trained now.  The expert-parallel MoE
    runs in ``"train"`` (with no mesh, the aam path) as in serving.  What
    still raises is the SSD kernel under autograd, which has no backward
    (the reference's Pallas kernel has none either): its message names
    ROADMAP Queue 1 item 9, unchanged.  It raises on a card only
    (``test_torch_cuda.py``), so here the message is read from the
    wrapper's source."""
    import inspect
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import smoke_model
    from repro_torch.kernels import ssd_chunk
    from repro_torch.moe import moe_layer
    cfg = smoke_model(ARCHS["phi3.5-moe-42b-a6.6b"])
    p = moe_layer.MoE(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(4, cfg.d_model, generator=torch.Generator().manual_seed(1))
    for mode in ("train", "prefill"):
        y, _ = moe_layer.moe_apply(cfg, p, x, impl="aam_shmap", mode=mode)
        assert torch.equal(y, moe_layer.moe_apply_aam(cfg, p, x, mode)[0])
    src = inspect.getsource(ssd_chunk.ssd_chunk_kernel)
    assert ('raise NotImplementedError("the SSD kernel has no backward yet "'
            '\n                                  "(ROADMAP Queue 1 item 9, '
            'training)")') in src


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "granite-34b",
                                  "gemma2-27b", "deepseek-67b", "qwen2-1.5b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-235b-a22b", "mamba2-780m",
                                  "pixtral-12b", "whisper-small"])
def test_every_family_builds_and_prefills_on_cpu(name):
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
    from repro_torch.models import model
    cfg = smoke_model(ARCHS[name])
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", 12, 2, "prefill"),
                     use_pallas=True)
    m = model.init(cfg, device="cpu")
    batch = {"tokens": torch.zeros(2, 12, dtype=torch.int32)}
    if cfg.encoder_layers:
        batch["frames"] = torch.zeros(2, cfg.encoder_seq, cfg.d_model)
    if cfg.frontend == "patch":
        batch["patch_embeds"] = torch.zeros(2, cfg.frontend_seq, cfg.d_model)
    logits, cache = model.prefill(cfg, rcfg, m, batch)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    assert cache is not None


@pytest.mark.parametrize("arch", ["whisper-small", "pixtral-12b"])
def test_serve_launcher_draws_frontend_stubs_on_cpu(arch):
    """whisper's frames and pixtral's patch embeddings come from the
    launcher's seed, as the reference launcher draws them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "6",
         "--new-tokens", "3"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith(f"[serve] {arch}: generated (2, 3) in ")
