"""The port's GPipe schedule (``train/pipeline.py``) on two gloo ranks
(``torch.multiprocessing`` spawn, one torch thread a rank, the stages on
the ``"pod"`` axis as the reference's ``tests/test_distributed.py``
sets it up), each rank holding only its stage:

* smoke qwen2 at ``num_layers=4`` (2 blocks a stage), 2 microbatches of
  2 x 32, on the reference's weights: the logits against the
  reference's ``M._forward`` on the same converted params, max error
  below the reference's 1e-2.  Both run in f32: in bf16 the two
  packages' own plain forwards already differ by 0.27 on these logits
  (up to 33 in size, where a bf16 step is 0.25), so the bound would
  measure rounding, not the schedule;
* the same model in f32 from a seed: the logits against the port's plain
  forward within 1e-5, and the gradients of a cross entropy on them
  (``backward()`` on every rank) against the plain forward's within 1e-5,
  the tied embedding's two stage shares summed;
* smoke phi3.5 (MoE) at ``num_layers=2``, f32, remat ``"full"``: each
  microbatch's logits against the plain forward of that microbatch alone
  (MoE capacity depends on the tokens a layer sees), and the gradients
  against the sum of the per-microbatch plain gradients, within 1e-5.

The ranks write their results to ``tmp_path``; the reference runs in
this process while they work.  The reference package is imported
inside the test: the spawned ranks import this module.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from _torch_once import once

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
from repro_torch.models import model as M
from repro_torch.train import pipeline as PP

SPAWN_TIMEOUT_S = 180
B, S, NMB = 4, 32, 2
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread
    each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name):
    if name == "moe":
        cfg = dataclasses.replace(smoke_model(ARCHS["phi3.5-moe-42b-a6.6b"]),
                                  num_layers=2)
        rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                         compute_dtype="float32", remat="full")
    else:
        cfg = dataclasses.replace(smoke_model(ARCHS["qwen2-1.5b"]),
                                  num_layers=4)
        rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                         remat="none", compute_dtype="float32")
    return cfg, rcfg


def _tokens(cfg, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                             .astype(np.int32)),
            torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                             .astype(np.int64)))


def _loss(logits, labels):
    """Mean over microbatches of each microbatch's mean cross entropy."""
    mb = B // NMB
    return sum(torch.nn.functional.cross_entropy(
        logits[i * mb:(i + 1) * mb].float().flatten(0, 1),
        labels[i * mb:(i + 1) * mb].flatten())
        for i in range(NMB)) / NMB


def _rank(rank, world, store_path, out_dir):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)      # ranks share the host's cores
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(axis="pod", group=dist.group.WORLD, device="cpu")
        out = {}
        for name in ("ref", "f32", "moe"):
            cfg, rcfg = _case(name)
            model = M.init(cfg, 0, device="cpu")
            if name == "ref":
                model.load_state_dict(torch.load(f"{out_dir}/ref_params.pt"))
            PP.keep_stage(cfg, model, mesh, "pod")
            toks, labels = _tokens(cfg, 1)
            f = PP.pipeline_forward(cfg, rcfg, mesh, "pod", NMB)
            if name == "ref":
                with torch.no_grad():
                    out["ref_logits"] = f(model, toks).float()
                continue
            logits = f(model, toks)
            _loss(logits, labels).backward()
            out[f"{name}_logits"] = logits.detach()
            out[f"{name}_grads"] = {k: p.grad for k, p in
                                    model.named_parameters()
                                    if p.grad is not None}
            out[f"{name}_staged"] = f.link.host_staged
            out[f"{name}_bytes"] = f.link.bytes_sent
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _plain(name):
    """(per-microbatch logits, gradients) of the plain forward: the whole
    batch at once for the dense model, each microbatch alone for the MoE;
    gradients of :func:`_loss`."""
    cfg, rcfg = _case(name)
    model = M.init(cfg, 0, device="cpu")
    toks, labels = _tokens(cfg, 1)
    if name == "moe":
        mb = B // NMB
        logits = torch.cat([M._forward(cfg, rcfg, model,
                                       {"tokens": toks[i * mb:(i + 1) * mb]},
                                       "train")[0] for i in range(NMB)])
    else:
        logits = M._forward(cfg, rcfg, model, {"tokens": toks}, "train")[0]
    _loss(logits, labels).backward()
    return logits.detach(), {k: p.grad for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    """Both ranks' results and the reference's f32 logits, once a run."""
    return once(tmp_path_factory, "pipe",
                 lambda: _run_pipe(tmp_path_factory))


def _run_pipe(tmp_path_factory):
    import jax
    from repro.configs.base import RunConfig as JRunConfig
    from repro.models import model as JM
    from repro_torch.convert import to_lm_params
    tmp = tmp_path_factory.mktemp("pipeline")
    cfg, rcfg = _case("ref")
    from repro.configs.archs import ARCHS as J_ARCHS
    from repro.configs.base import smoke_model as j_smoke
    jcfg = dataclasses.replace(j_smoke(J_ARCHS["qwen2-1.5b"]), num_layers=4)
    params, _ = JM.init(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    torch.save(to_lm_params(cfg, params, device="cpu"),
               tmp / "ref_params.pt")
    world = 2
    ctx = mp.start_processes(_rank, args=(world, str(tmp / "store"),
                                          str(tmp)),
                             nprocs=world, join=False, start_method="spawn")
    try:
        toks, _ = _tokens(cfg, 1)
        jr = JRunConfig(model=jcfg, shape=rcfg.shape, remat="none",
                        compute_dtype="float32")
        ref, _, _ = JM._forward(jcfg, jr, params,
                                {"tokens": np.asarray(toks)}, mode="train")
        ref = np.asarray(ref.astype(np.float32))
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo pipeline did not finish in "
                            f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(world)]
    return ranks, ref


def test_stage_layers_follow_the_blocks():
    cfg = smoke_model(ARCHS["jamba-1.5-large-398b"])
    cfg = dataclasses.replace(cfg, num_layers=4 * len(cfg.full_pattern))
    n = len(cfg.full_pattern)
    assert PP.stage_layers(cfg, 1, 2) == [j * n + i for j in (2, 3)
                                          for i in range(n)]
    with pytest.raises(ValueError, match="do not split"):
        PP.stage_layers(cfg, 0, 3)


def test_pipeline_matches_reference_forward(pipe):
    ranks, ref = pipe
    for r in ranks:
        err = float(np.abs(r["ref_logits"].numpy() - ref).max())
        assert err < 1e-2, err


@pytest.mark.parametrize("name", ["f32", "moe"])
def test_pipeline_logits_match_plain_forward(pipe, name):
    ranks, _ = pipe
    want, _ = _plain(name)
    for r in ranks:
        torch.testing.assert_close(r[f"{name}_logits"], want, rtol=0,
                                   atol=TOL)
        assert r[f"{name}_staged"] is False     # CPU stages send directly
    # one [mb, S, d] activation a microbatch crosses the boundary
    cfg, _ = _case(name)
    assert ranks[0][f"{name}_bytes"] == B * S * cfg.d_model * 4
    assert ranks[1][f"{name}_bytes"] == 0


@pytest.mark.parametrize("name", ["f32", "moe"])
def test_gradients_flow_through_the_schedule(pipe, name):
    ranks, _ = pipe
    _, want = _plain(name)
    cfg, _ = _case(name)
    got = {}
    for r in ranks:
        for k, g in r[f"{name}_grads"].items():
            got[k] = got[k] + g if k in got else g   # tied embedding: summed
    assert set(got) == set(want)
    for stage, r in enumerate(ranks):
        held = {k.split(".")[1] for k in r[f"{name}_grads"]
                if k.startswith("layers.")}
        assert held == {str(l) for l in PP.stage_layers(cfg, stage, 2)}
    for k, g in want.items():
        torch.testing.assert_close(got[k], g, rtol=0, atol=TOL,
                                   msg=lambda m, k=k: f"{k}: {m}")
