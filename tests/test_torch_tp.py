"""Tensor-parallel compute over ``"model"`` (``runtime/sharding.py``'s
operators, the layers of ``models/*.py`` and ``moe/moe_layer.py`` on their
local shards, ``train_step.make_sharded_train_step``, sharded serving) on
gloo CPU ranks, at smoke width, f32.

* **Parity with the unsharded step.** On ``(1, 2)`` and ``(2, 2)``
  meshes (2 and 4 spawned ranks, one torch thread each), the sharded
  gradients, loss and one AdamW step against ``grads_fn`` and
  ``make_train_step`` on the whole global batch: loss within rtol 1e-5,
  every leaf's gradient within rtol 1e-4 / atol 1e-6, parameters after
  the step within ``PARAM_ATOL`` of the unsharded clip and AdamW update
  applied to the sharded gradients (a first AdamW step divides each
  gradient by its own size, so an element whose gradient is near AdamW's
  eps moves a fraction of the learning rate under a difference the
  gradient bound admits; the gradients are held to the unsharded ones
  above).  The configs put every fallback of a
  two-wide ``"model"`` axis on the path: heads and kv heads split
  (qwen2: tied embeddings, QKV bias, a padded vocab), kv heads whole and
  q heads split (granite, one kv head), q heads whole and the MLP split
  (gemma2 at 3 heads: softcaps, post-norms, a local window), MoE with
  split experts (phi3.5: untied; qwen3-moe: q/k norms), Mamba2 (mamba2),
  hybrid (jamba), the vlm prefix with ignored labels (pixtral) and the
  encoder-decoder (whisper).  The MoE archs on ``(2, 2)`` are held to the
  mean over the two data shards of the unsharded gradients on each
  (ROADMAP Queue 3: capacity follows the tokens a layer sees).  Whisper
  is held to ``test_torch_train.py``'s bf16 bound: its cross K/V are
  rounded to bf16 at f32 compute, so the partial sums of the sharded
  encoder can move one bf16 rounding by a step; each leaf's gradient
  within 2**-8 of its largest.
* **Collectives.** Under ``CommDebugMode`` on ``(1, 2)`` (where every
  collective is over ``"model"``) the only all-gathers are of MoE
  routers, which the layer reads whole; no other weight is gathered.
* **Parity with the reference.** The prefill logits on ``(1, 2)`` under
  ``SERVE_TP_RULES``, gathered over the vocab, against the reference's
  ``_forward`` on the same weights (``convert.to_lm_params``), f32, at the
  pipeline test's bound.
* **Decode.** ``serve_step.generate`` on ``(1, 2)`` under
  ``SERVE_TP_RULES`` equals the unsharded ``generate`` token for token,
  and so does ``launch.serve`` on two ranks (``WORLD_SIZE=2``, the
  reference's ``make_host_mesh(1, world)``) against one.

The ranks read the weights from the seed and the batches from
``TokenStream``; rank 0 writes the results, read here once a run and
shared across xdist workers (``_torch_once``).  The reference package is
imported inside the tests: the spawned ranks import this module.
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
from repro_torch.data.pipeline import TokenStream
from repro_torch.models import model as M
from repro_torch.runtime import sharding as shd
from repro_torch.train import train_step as T
from repro_torch.train.optimizer import make_optimizer

SPAWN_TIMEOUT_S = 240
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
PARAM_ATOL = 1e-5
REF_ATOL = 1e-2         # the pipeline test's bound against the reference
BF16_STEP = 2.0 ** -8   # whisper's bound (above)
RULES = shd.ShardingRules(shd.TRAIN_RULES)
SERVE = shd.ShardingRules(shd.SERVE_TP_RULES)
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
CASES = {   # name -> (arch, overrides of its smoke config)
    "qwen2": ("qwen2-1.5b", {}),
    "granite_kv1": ("granite-34b", {}),
    "gemma2_heads3": ("gemma2-27b", {"num_heads": 3, "num_kv_heads": 1}),
    "phi35_moe": ("phi3.5-moe-42b-a6.6b", {}),
    "qwen3_moe": ("qwen3-moe-235b-a22b", {}),
    "mamba2": ("mamba2-780m", {}),
    "jamba": ("jamba-1.5-large-398b", {}),
    "pixtral": ("pixtral-12b", {}),
    "whisper": ("whisper-small", {}),
}
SERVE_CASES = ("qwen2", "phi35_moe", "mamba2", "whisper")
B, S, NEW = 4, 16, 4      # serving: batch, prompt, generated tokens


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread
    each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name):
    arch, over = CASES[name]
    cfg = dataclasses.replace(smoke_model(ARCHS[arch]), **over)
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", 16, 4, "train"),
                     compute_dtype="float32", remat="full")
    return cfg, rcfg


def _serve_case(name):
    cfg, _ = _case(name)
    return cfg, RunConfig(model=cfg, shape=ShapeConfig("s", S + NEW, B,
                                                       "decode"),
                          compute_dtype="float32", remat="none")


def _serve_batch(cfg):
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (B, S)),
                                       dtype=torch.int32)}
    if cfg.encoder_layers:
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32)
    return batch


def _gathers(log):
    """Result bytes of each all-gather a ``CollectiveLog`` saw."""
    return [b for kind, b, _ in log.log if kind == "all-gather"]


def _model_sharded(x) -> bool:
    return any(p.is_shard() for n, p in zip(x.device_mesh.mesh_dim_names,
                                            x.placements) if n == "model")


def _train_rank(cfg, rcfg, mesh, out):
    from repro_torch.launch.dryrun import _collective_log_class
    _, params, opt_state = T.init_train_state(cfg, rcfg, device="cpu")
    opt = make_optimizer(rcfg)
    sp = shd.shard_tree(params, RULES, mesh)
    so = shd.shard_tree(opt_state, RULES, mesh)
    batch = TokenStream(cfg, rcfg.shape, seed=0).batch(0)
    grads, _, _ = T.make_sharded_grads(cfg, rcfg, mesh)(sp, batch)
    step = T.make_sharded_train_step(cfg, rcfg, opt, mesh, RULES)
    log = _collective_log_class()()
    with log:
        sp, so, metrics = step(sp, so, 0, batch)
    out.update(grads={k: g.full_tensor() for k, g in grads.items()},
               params={k: v.full_tensor() for k, v in sp.items()},
               loss=float(metrics["loss"]), gathers=_gathers(log),
               sharded=sorted(k for k, v in sp.items() if _model_sharded(v)))


def _serve_rank(name, mesh, weights, out):
    """Prefill logits and ``generate``'s tokens under ``SERVE_TP_RULES``
    on ``weights`` (the reference's, converted)."""
    from repro_torch.serve.serve_step import generate
    cfg, rcfg = _serve_case(name)
    params = shd.shard_tree(weights, SERVE, mesh)
    model, slots = T.sharded_model(cfg, rcfg)
    shd.bind(slots, params)
    batch = _serve_batch(cfg)
    with torch.no_grad():
        logits, _, _ = M._forward(cfg, rcfg, model, batch, "prefill")
        out["logits"] = M.whole_logits(cfg, model, logits)
    out["tokens"] = generate(cfg, rcfg, model, batch, max_new_tokens=NEW,
                             device="cpu")


def _launch(world: int):
    """``launch.serve``'s tokens for a smoke qwen2 on ``world`` ranks (as
    ``torchrun`` would set ``WORLD_SIZE``; the group is running)."""
    import os
    from repro_torch.launch import serve
    before = os.environ.get("WORLD_SIZE")
    os.environ["WORLD_SIZE"] = str(world)
    try:
        return serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device",
                           "cpu", "--new-tokens", str(NEW)])
    finally:
        if before is None:
            del os.environ["WORLD_SIZE"]
        else:
            os.environ["WORLD_SIZE"] = before


def _rank(rank, world, store_path, out_dir, dims):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)      # ranks share the host's cores
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(*dims, device="cpu")
        results = {}
        for name in CASES:
            results[name] = {}
            _train_rank(*_case(name), mesh, results[name])
        if dims == (1, 2):
            weights = torch.load(f"{out_dir}/serve_weights.pt")
            for name in SERVE_CASES:
                results[f"serve:{name}"] = {}
                _serve_rank(name, mesh, weights[name],
                            results[f"serve:{name}"])
            results["launcher"] = _launch(world)
        if rank == 0:
            torch.save(results, f"{out_dir}/rank0.pt")
    finally:
        dist.destroy_process_group()


def _oracle(name, n_data):
    """The unsharded gradients (per-data-shard mean for an MoE on a split
    batch) and loss."""
    cfg, rcfg = _case(name)
    model, params, _ = T.init_train_state(cfg, rcfg, device="cpu")
    batch = TokenStream(cfg, rcfg.shape, seed=0).tensors(0, device="cpu")
    if cfg.num_experts and n_data > 1:
        b = rcfg.shape.global_batch // n_data
        runs = [T.grads_fn(cfg, rcfg, model,
                           {k: v[j * b:(j + 1) * b] for k, v in batch.items()})
                for j in range(n_data)]
        grads = {k: sum(r[0][k] for r in runs) / n_data for k in params}
        loss = float(sum(r[1] for r in runs) / n_data)
    else:
        grads, loss, _ = T.grads_fn(cfg, rcfg, model, batch)
        loss = float(loss)
    return {"grads": {k: g.detach().clone() for k, g in grads.items()},
            "loss": loss}


def _reference(name):
    """(the reference's f32 weights of the serving case as the port's
    state dict, the reference's ``_forward`` prefill logits on them)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.archs import ARCHS as JARCHS
    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import smoke_model as jsmoke
    from repro.models import model as JM
    from repro_torch.convert import to_params
    arch, over = CASES[name]
    jcfg = dataclasses.replace(jsmoke(JARCHS[arch]), **over)
    cfg, rcfg = _serve_case(name)
    params, _ = JM.init(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    jr = JRunConfig(model=jcfg, shape=rcfg.shape, remat="none",
                    compute_dtype="float32")
    jb = {k: jnp.asarray(v.numpy()) for k, v in _serve_batch(cfg).items()}
    logits, _, _ = JM._forward(jcfg, jr, params, jb, mode="prefill")
    return (to_params(cfg, params, device="cpu"),
            torch.from_numpy(np.array(logits, dtype=np.float32)))


def _unsharded_tokens(name, weights):
    from repro_torch.serve.serve_step import generate
    cfg, rcfg = _serve_case(name)
    model = M.init(cfg, 0, device="cpu")
    model.load_state_dict(weights)
    return generate(cfg, rcfg, model, _serve_batch(cfg), max_new_tokens=NEW,
                    device="cpu")


def _run(tmp_path_factory, mesh_name):
    dims = MESHES[mesh_name]
    world = dims[0] * dims[1]
    tmp = tmp_path_factory.mktemp(f"tp_{mesh_name}")
    want = {}
    if dims == (1, 2):
        refs = {name: _reference(name) for name in SERVE_CASES}
        torch.save({k: w for k, (w, _) in refs.items()},
                   tmp / "serve_weights.pt")
    ctx = mp.start_processes(_rank, args=(world, str(tmp / "store"),
                                          str(tmp), dims),
                             nprocs=world, join=False, start_method="spawn")
    try:
        want = {name: _oracle(name, dims[0]) for name in CASES}
        if dims == (1, 2):
            want.update((f"serve:{k}", {
                "ref_logits": logits,
                "tokens": _unsharded_tokens(k, w)})
                for k, (w, logits) in refs.items())
            want["launcher"] = _launch(1)
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"the {mesh_name} gloo ranks did not finish in "
                            f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return torch.load(tmp / "rank0.pt"), want


def _ran(tmp_path_factory, name):
    return name, once(tmp_path_factory, f"tp_{name}",
                      lambda: _run(tmp_path_factory, name))


@pytest.fixture(scope="module", params=sorted(MESHES))
def ran(request, tmp_path_factory):
    return _ran(tmp_path_factory, request.param)


@pytest.fixture(scope="module")
def ran_1x2(tmp_path_factory):
    """The ``(1, 2)`` run, where every collective is over ``"model"`` and
    the serving cases run."""
    return _ran(tmp_path_factory, "1x2")


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_loss_and_gradients_match_unsharded(ran, case):
    mesh, (got, want) = ran
    g, w = got[case], want[case]
    np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
    assert set(g["grads"]) == set(w["grads"])
    for k, ref in w["grads"].items():
        if case == "whisper":
            bound = BF16_STEP * float(ref.abs().max())
            assert float((g["grads"][k] - ref).abs().max()) <= bound, k
            continue
        torch.testing.assert_close(
            g["grads"][k], ref, rtol=GRAD_RTOL, atol=GRAD_ATOL,
            msg=lambda m, k=k: f"{mesh} {case} {k}: {m}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_unsharded(ran, case):
    mesh, (got, _) = ran
    cfg, rcfg = _case(case)
    _, params, opt_state = T.init_train_state(cfg, rcfg, device="cpu")
    grads = {k: g.clone() for k, g in got[case]["grads"].items()}
    grads, _ = T.clip_by_global_norm(grads, rcfg.grad_clip)
    params, _ = make_optimizer(rcfg).update(grads, opt_state, params, 0)
    for k, ref in params.items():
        torch.testing.assert_close(
            got[case]["params"][k], ref.detach(), rtol=0, atol=PARAM_ATOL,
            msg=lambda m, k=k: f"{mesh} {case} {k}: {m}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_weight_is_gathered_over_model_but_routers(ran_1x2, case):
    """On ``(1, 2)`` every collective is over ``"model"``: the step's
    all-gathers are MoE routers alone (read whole for the top-k), and the
    rules split weights over ``"model"`` in every case."""
    _, (got, _) = ran_1x2
    cfg, _ = _case(case)
    router = cfg.d_model * cfg.num_experts * 4
    assert all(b == router for b in got[case]["gathers"])
    assert bool(got[case]["gathers"]) == bool(cfg.num_experts)
    assert got[case]["sharded"]


@pytest.mark.parametrize("case", SERVE_CASES)
def test_sharded_prefill_matches_reference_forward(ran_1x2, case):
    _, (got, want) = ran_1x2
    g, w = got[f"serve:{case}"], want[f"serve:{case}"]
    cfg, _ = _case(case)
    v = cfg.vocab_size
    err = float((g["logits"][..., :v] - w["ref_logits"][..., :v]).abs().max())
    assert err < REF_ATOL, err


def test_serve_launcher_on_two_ranks_matches_one(ran_1x2):
    """``launch.serve`` on the ``(1, 2)`` serving mesh generates the
    tokens it generates on one rank."""
    _, (got, want) = ran_1x2
    assert got["launcher"].shape == (4, NEW)
    assert torch.equal(got["launcher"], want["launcher"])


@pytest.mark.parametrize("case", SERVE_CASES)
def test_sharded_decode_matches_unsharded_tokens(ran_1x2, case):
    _, (got, want) = ran_1x2
    assert torch.equal(got[f"serve:{case}"]["tokens"],
                       want[f"serve:{case}"]["tokens"])
