"""The port's parallel layouts (``runtime/sharding.py``, the mesh functions
of ``launch/mesh.py`` and ``train_step.make_sharded_train_step``)
against the reference's, on the CPU.

* **Rules.** For every leaf of every arch in ``ARCHS`` — parameters,
  AdamW's and Adafactor's states, and the decode caches of
  ``decode_32k`` — on the 16 x 16 and 2 x 16 x 16 production meshes (the
  reference's ``FakeMesh`` idiom, ``tests/test_runtime.py``): the port's
  name-based ``resolve_axes`` equals the reference's path-based one on the
  same leaf (the port's names map to the reference's paths as
  ``convert.py`` maps them), with the reference's leading replicated
  layer axis dropped where it stacks layers, and ``spec_for`` equals the
  reference's ``PartitionSpec`` entry for entry.  The reference's three
  sharding cases are ported to the port's names.
* **Placements.** On a ``fake`` process group of 512 ranks, a dim
  sharded over ``("pod", "data")`` splits pod-major, as in JAX.
* **The sharded step.** 2 x 2 gloo CPU ranks (4 spawned ranks, one torch
  thread each) run 2 f32 steps of ``make_sharded_train_step`` (computing
  tensor-parallel over ``"model"``; ``tests/test_torch_tp.py`` covers
  every fallback) with parameters and AdamW state as DTensors in the
  training rules' layout:
  smoke qwen2 against the unsharded ``make_train_step`` on the whole
  global batch, smoke phi3.5 (MoE) against the mean, over the two data
  shards, of the unsharded step's gradients on each shard (an MoE layer
  sizes its capacity from the tokens it sees), parameters within
  ``PARAM_ATOL``; and the collectives ``CommDebugMode`` counts on a
  ``fake`` group of 4 equal those the gloo run issued.

Every ``fake`` group is started and destroyed in ``finally`` inside its
test; the gloo groups live in the spawned ranks.  The reference package
is imported inside the tests: the spawned ranks import this module.
"""
import time
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from _torch_once import once

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import SHAPES, RunConfig, ShapeConfig, smoke_model
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import dryrun as D
from repro_torch.models import model as M
from repro_torch.runtime import sharding as shd
from repro_torch.train import train_step as T
from repro_torch.train.optimizer import make_optimizer

SPAWN_TIMEOUT_S = 180
PARAM_ATOL = 1e-5      # parameters after 2 f32 AdamW steps
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULES = shd.ShardingRules(shd.TRAIN_RULES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread
    each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


# ------------------------------------------------------------------ rules

_REFERENCE = {}


def _reference_trees(arch):
    """The reference's abstract trees of ``arch``, flattened: {kind:
    {plain key path: (jax key path, ShapeDtypeStruct)}}."""
    if arch in _REFERENCE:
        return _REFERENCE[arch]
    import jax
    from repro.configs.archs import ARCHS as JARCHS
    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import SHAPES as JSHAPES
    from repro.models import model as JM
    from repro.train.optimizer import adafactor, adamw
    jcfg = JARCHS[arch]
    params = JM.param_specs(jcfg)
    jr = JRunConfig(model=jcfg, shape=JSHAPES["decode_32k"])
    trees = {"params": params,
             "adamw": jax.eval_shape(adamw(jr).init, params),
             "adafactor": jax.eval_shape(adafactor(jr).init, params),
             "cache": JM.cache_specs(jcfg, jr, JSHAPES["decode_32k"])}
    out = {}
    for kind, tree in trees.items():
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        out[kind] = {tuple(getattr(k, "key", getattr(k, "idx", None))
                           for k in path): (path, leaf)
                     for path, leaf in flat}
    _REFERENCE[arch] = out
    return out


def _port_trees(arch):
    """The port's trees of ``arch`` on ``meta``: {kind: {dotted name:
    tensor}}."""
    cfg = ARCHS[arch]
    params = M.param_specs(cfg)
    rcfg = RunConfig(model=cfg, shape=SHAPES["decode_32k"])
    from repro_torch.train.optimizer import adafactor, adamw
    trees = {"params": params, "adamw": adamw(rcfg).init(params),
             "adafactor": adafactor(rcfg).init(params),
             "cache": M.cache_specs(cfg, rcfg, SHAPES["decode_32k"])}
    return {kind: dict(shd.tree_items(t)) for kind, t in trees.items()}


def _reference_key(cfg, kind, name):
    """The reference's plain key path of the port's leaf ``name``."""
    keys = name.split(".")
    prefix = []
    if kind == "adamw":
        prefix, keys = [keys[0]], keys[1:]
    if kind == "cache":
        return tuple(int(k) if k.isdigit() else k for k in keys)
    if keys[0] == "layers":
        keys = ["blocks", int(keys[1]) % len(cfg.full_pattern)] + keys[2:]
    elif keys[0] in ("encoder", "decoder"):
        keys = [keys[0]] + keys[2:]
    return tuple(prefix + keys)


@pytest.mark.parametrize("kind", ["params", "adamw", "adafactor", "cache"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_match_reference_on_every_leaf(arch, mesh, kind):
    from repro.runtime import sharding as jshd
    jrules = jshd.ShardingRules(jshd.TRAIN_RULES)
    fake = FakeMesh(MESHES[mesh])
    ref = _reference_trees(arch)[kind]
    port = _port_trees(arch)[kind]
    cfg = ARCHS[arch]
    hit = set()
    for name, x in port.items():
        key = _reference_key(cfg, kind, name)
        assert key in ref, (name, key)
        hit.add(key)
        path, leaf = ref[key]
        ref_axes = jshd.resolve_axes(path, len(leaf.shape))
        ref_spec = tuple(jrules.spec_for(ref_axes, leaf.shape, fake))
        if len(leaf.shape) == x.dim() + 1:        # the reference stacks it
            assert tuple(leaf.shape[1:]) == tuple(x.shape), name
            assert ref_axes[0] is None and (not ref_spec or
                                            ref_spec[0] is None), name
            ref_axes, ref_spec = ref_axes[1:], ref_spec[1:]
        else:
            assert tuple(leaf.shape) == tuple(x.shape), name
        axes = shd.resolve_axes(name, x.dim())
        assert axes == tuple(ref_axes), name
        spec = RULES.spec_for(axes, x.shape, fake)
        assert isinstance(spec, shd.PartitionSpec)
        assert tuple(spec) == ref_spec, (name, spec, ref_spec)
    assert hit == set(ref), sorted(set(ref) - hit)[:5]


def test_divisibility_fallback():
    spec = RULES.spec_for(("embed", "kv_heads", "head_dim"), (4096, 8, 128),
                          FakeMesh(MESHES["16x16"]))
    assert spec == shd.PartitionSpec("data")     # kv 8 !| 16 dropped
    spec2 = RULES.spec_for(("embed", "heads", "head_dim"), (4096, 64, 128),
                           FakeMesh(MESHES["16x16"]))
    assert spec2 == shd.PartitionSpec("data", "model")
    # a mesh axis shards one dim only, and ("pod", "data") keeps both
    spec3 = RULES.spec_for(("batch", "vocab", "mlp"), (64, 512, 256),
                           FakeMesh(MESHES["2x16x16"]))
    assert spec3 == shd.PartitionSpec(("pod", "data"), "model")


def test_resolve_axes_param_names():
    params = M.param_specs(ARCHS["qwen3-moe-235b-a22b"])
    by_name = {k: shd.resolve_axes(k, v.dim()) for k, v in params.items()}
    moe_wi = [a for n, a in by_name.items() if n.endswith("mlp.wi")]
    assert moe_wi and all(a == ("experts", "embed", "mlp") for a in moe_wi)
    assert by_name["embed.embedding"] == ("vocab", "embed")
    att_wo = [a for n, a in by_name.items() if n.endswith("mixer.wo")]
    assert att_wo and all(a == ("heads", "head_dim", "embed")
                          for a in att_wo)
    assert shd.tree_logical_axes(params) == by_name
    phi = M.param_specs(ARCHS["phi3.5-moe-42b-a6.6b"])
    assert tuple(phi["layers.0.mixer.wo"].shape) == (32, 128, 4096)
    assert tuple(phi["layers.0.mlp.wo"].shape) == (16, 6400, 4096)


def test_resolve_axes_optimizer_states():
    from repro_torch.train.optimizer import adafactor
    cfg = ARCHS["qwen2-1.5b"]
    rcfg = RunConfig(model=cfg, shape=SHAPES["train_4k"],
                     optimizer="adafactor")
    state = adafactor(rcfg).init(M.param_specs(cfg))
    by_name = {k: shd.resolve_axes(k, v.dim())
               for k, v in shd.tree_items(state)}
    # adafactor factored moments inherit the parent param's axes
    assert by_name["embed.embedding.vr"] == ("vocab",)
    assert by_name["embed.embedding.vc"] == ("embed",)
    assert by_name["layers.3.norm1.vc"] == ("norm",)    # shared over layers
    assert by_name["final_norm.v"] == ("norm",)


def test_logical_constraint_passes_plain_tensors():
    x = torch.ones(4, 8)
    assert shd.logical_constraint(RULES, x, ("batch", "act_embed")) is x
    assert T.constrain_like_params({"layers.0.norm1": x})[
        "layers.0.norm1"] is x


# ------------------------------------------------------- DTensor layouts


@pytest.mark.parametrize("rank,rows", [(0, 0), (17, 2), (256 + 17, 34),
                                       (511, 62)])
def test_pod_data_shards_split_pod_major(rank, rows):
    """Rank (pod p, data d, model m) of 2 x 16 x 16 holds rows
    ``2 (16 p + d)`` of a 64-row batch sharded over ("pod", "data")."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with D.fake_mesh((2, 16, 16), ("pod", "data", "model"), rank) as dm:
        pl = RULES.placements_for(("batch", "vocab"), (64, 512), dm)
        assert pl == [Shard(0), Shard(0), Shard(1)]
        assert shd.placements_for(shd.PartitionSpec(None, "model"), dm) == \
            [Replicate(), Replicate(), Shard(1)]
        x = torch.arange(64 * 512, dtype=torch.float32).reshape(64, 512)
        local = distribute_tensor(x, dm, pl, src_data_rank=None).to_local()
        assert local.shape == (2, 32)
        col = 32 * (rank % 16)
        assert torch.equal(local, x[rows:rows + 2, col:col + 32])
        idx, n = shd.batch_coordinate(dm)
        assert (idx * 2, n) == (rows, 32)
        y = shd.logical_constraint(
            RULES, distribute_tensor(x, dm, [Replicate()] * 3,
                                     src_data_rank=None), ("batch", "vocab"))
        assert y.placements == tuple(pl)


def test_host_mesh_checks_the_world_size():
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    with D.fake_mesh((2, 2), ("data", "model")):
        m = make_host_mesh(2, 2, device="cpu")
        assert m.mesh_dim_names == ("data", "model")
        assert tuple(m.shape) == (2, 2)
        with pytest.raises(ValueError, match="needs world size 256"):
            make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="needs world size 512"):
            make_production_mesh(multi_pod=True, device="cpu")
        assert tuple(make_host_mesh(1, 2, pod=2, device="cpu")
                     .mesh_dim_names) == ("pod", "data", "model")


def test_launcher_production_mesh_needs_256_ranks():
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="needs world size 256"):
        train.main(["--smoke", "--production-mesh", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs world size 4"):
        train.main(["--smoke", "--mesh", "2,2", "--device", "cpu"])


# ------------------------------------------------------- the sharded step


def _step_case(arch):
    cfg = smoke_model(ARCHS[arch])
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                     compute_dtype="float32", remat="full")
    return cfg, rcfg


def _counts(cm):
    return {str(k): v for k, v in sorted(cm.get_comm_counts().items(),
                                         key=lambda kv: str(kv[0]))}


def _step_rank(rank, world, store_path, out_dir, arch):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)      # ranks share the host's cores
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(2, 2, device="cpu")
        cfg, rcfg = _step_case(arch)
        _, params, opt_state = T.init_train_state(cfg, rcfg, device="cpu")
        opt = make_optimizer(rcfg)
        sp = shd.shard_tree(params, RULES, mesh)
        so = shd.shard_tree(opt_state, RULES, mesh)
        layout = {k: (type(v) is DTensor, tuple(map(str, v.placements)))
                  for k, v in shd.tree_items({"params": sp, "opt": so})}
        step = T.make_sharded_train_step(cfg, rcfg, opt, mesh, RULES)
        stream = TokenStream(cfg, rcfg.shape, seed=0)
        counts, losses = [], []
        for i in range(2):
            with CommDebugMode() as cm:
                sp, so, metrics = step(sp, so, i, stream.batch(i))
            counts.append(_counts(cm))
            losses.append(float(metrics["loss"]))
        same = all(type(v) is DTensor for v in list(sp.values()) +
                   [v for _, v in shd.tree_items(so)])
        whole = {k: v.full_tensor() for k, v in sp.items()}
        launched = []
        if cfg.num_experts == 0:
            # the launcher on the same mesh: 2 steps, then a resume to 3
            from repro_torch.launch import train as launch_train
            argv = ["--smoke", "--device", "cpu", "--mesh", "2,2",
                    "--batch", "4", "--seq", "16", "--save-every", "1",
                    "--ckpt-dir", f"{out_dir}/ckpt"]
            for steps in ("2", "3"):
                r = launch_train.main(argv + ["--steps", steps])
                launched.append((r["start"], r["final"],
                                 float(r["log"][-1][1]["loss"])))
                dist.barrier()      # rank 0's checkpoint is written
        if rank == 0:
            torch.save({"params": whole, "counts": counts, "losses": losses,
                        "layout": layout, "still_dtensors": same,
                        "launched": launched}, f"{out_dir}/rank0.pt")
    finally:
        dist.destroy_process_group()


def _oracle(arch):
    """(params after 2 steps, losses): the unsharded step on the whole
    batch (dense), or the per-data-shard mean of its gradients (MoE)."""
    cfg, rcfg = _step_case(arch)
    model, params, opt_state = T.init_train_state(cfg, rcfg, device="cpu")
    opt = make_optimizer(rcfg)
    stream = TokenStream(cfg, rcfg.shape, seed=0)
    losses = []
    if cfg.num_experts == 0:
        step = T.make_train_step(cfg, rcfg, model, opt)
        for i in range(2):
            params, opt_state, m = step(params, opt_state, i, stream.batch(i))
            losses.append(float(m["loss"]))
        return {k: v.detach() for k, v in params.items()}, losses
    for i in range(2):
        batch = stream.tensors(i, device="cpu")
        shards = [{k: v[j * 4:(j + 1) * 4] for k, v in batch.items()}
                  for j in range(2)]
        runs = [T.grads_fn(cfg, rcfg, model, s) for s in shards]
        grads = {k: (runs[0][0][k] + runs[1][0][k]) / 2 for k in params}
        grads, _ = T.clip_by_global_norm(grads, rcfg.grad_clip)
        params, opt_state = opt.update(grads, opt_state, params, i)
        losses.append(float((runs[0][1] + runs[1][1]) / 2))
    return {k: v.detach() for k, v in params.items()}, losses


def _fake_counts(arch):
    """``CommDebugMode`` counts of the same 2 steps on a ``fake`` group of
    4 ranks, on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    cfg, rcfg = _step_case(arch)
    counts = []
    with D.fake_mesh((2, 2), ("data", "model")) as dm, FakeTensorMode():
        params = {k: torch.zeros(v.shape, dtype=v.dtype)
                  for k, v in M.param_specs(cfg).items()}
        opt = make_optimizer(rcfg)
        sp = shd.shard_tree(params, RULES, dm)
        so = shd.shard_tree(opt.init(params), RULES, dm)
        step = T.make_sharded_train_step(cfg, rcfg, opt, dm, RULES)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
                 M.input_specs(cfg, rcfg.shape).items()}
        for i in range(2):
            with CommDebugMode() as cm:
                sp, so, _ = step(sp, so, i, batch)
            counts.append(_counts(cm))
    return counts


def _run_step(tmp_path_factory, arch):
    tmp = tmp_path_factory.mktemp("sharded_step")
    world = 4
    ctx = mp.start_processes(_step_rank, args=(world, str(tmp / "store"),
                                               str(tmp), arch),
                             nprocs=world, join=False, start_method="spawn")
    try:
        want, want_losses = _oracle(arch)
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"the 2 x 2 gloo step did not finish in "
                            f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    got = torch.load(tmp / "rank0.pt")
    got.update(want=want, want_losses=want_losses)
    return got


@pytest.fixture(scope="module", params=["qwen2-1.5b", "phi3.5-moe-42b-a6.6b"])
def stepped(request, tmp_path_factory):
    arch = request.param
    return arch, once(tmp_path_factory, arch,
                       lambda: _run_step(tmp_path_factory, arch))


def test_sharded_step_matches_unsharded(stepped):
    arch, r = stepped
    assert set(r["params"]) == set(r["want"])
    for k, w in r["want"].items():
        torch.testing.assert_close(r["params"][k], w, rtol=0,
                                   atol=PARAM_ATOL,
                                   msg=lambda m, k=k: f"{arch} {k}: {m}")
    np.testing.assert_allclose(r["losses"], r["want_losses"], rtol=1e-6)


def test_sharded_state_is_dtensors_in_the_rules_layout(stepped):
    arch, r = stepped
    cfg, rcfg = _step_case(arch)
    assert r["still_dtensors"]
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2))
    params = M.param_specs(cfg)
    opt = shd.tree_shardings(RULES, make_optimizer(rcfg).init(params), mesh)
    want_pl = {f"params.{k}": v for k, v in
               shd.tree_shardings(RULES, params, mesh).items()}
    want_pl.update((f"opt.{s}.{k}", v) for s in opt
                   for k, v in opt[s].items())
    sharded = 0
    for path, pl in want_pl.items():
        want = tuple(map(str, pl))
        is_dt, got = r["layout"][path]
        assert is_dt and got == want, (path, got, want)
        sharded += any(p.startswith("S(") for p in got)
    assert sharded > len(params)      # FSDP and TP shards, params and m, v


def test_launcher_trains_and_resumes_on_the_mesh(tmp_path_factory):
    """``launch.train --mesh 2,2`` in the dense arch's spawn: 2 steps with
    DTensor checkpoints, then a resume from step 2 to 3."""
    arch = "qwen2-1.5b"
    r = once(tmp_path_factory, arch, lambda: _run_step(tmp_path_factory,
                                                        arch))
    (s0, f0, l0), (s1, f1, l1) = r["launched"]
    assert (s0, f0, s1, f1) == (0, 2, 2, 3)
    assert np.isfinite(l0) and np.isfinite(l1)


def test_fake_group_counts_equal_the_gloo_run(stepped):
    arch, r = stepped
    fake = _fake_counts(arch)
    assert fake == r["counts"], (fake, r["counts"])
    kinds = set(r["counts"][0])
    assert any("all_gather" in k for k in kinds)
    assert any("reduce_scatter" in k for k in kinds)
