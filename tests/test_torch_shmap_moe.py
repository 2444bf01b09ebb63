"""The port's expert-parallel MoE (``moe/shmap_moe.py``) against the
reference's ``moe_apply_aam``.

Four gloo ranks (``torch.multiprocessing`` spawn, one ``FileStore``, one
torch thread a rank) form a 2 data x 2 model mesh: each data index holds
half of the tokens, each model rank half of the experts.  Every case runs
in one spawn, shared by the run's pytest-xdist workers.  A rank's output
must equal the reference's ``moe_apply_aam`` on its token slice (the
train capacity is the slice's, so the drops are the slice's too),
``moe_dropped`` the sum over the slices and ``moe_aux`` their mean (the
reference's ``psum`` and ``pmean``), all within 1e-5; without drops the
gathered output also equals ``moe_apply_aam`` over all tokens.
Gradients of ``sum(out · r) + aux``, reduced by
``shmap_moe.reduce_expert_grads`` (expert weights summed over the model
group, every gradient averaged over the data group), equal ``jax.grad``
of the mean over the slices of the same loss on ``moe_apply_aam``, within
1e-5 of each leaf's largest entry (the router's gradient sums terms of up to 100 that
cancel, so f32 summation order shows at 1e-5 relative).

The reference package is imported inside the functions that run it: the
spawned ranks import this module, and without JAX they start in half
the time.
"""
import dataclasses
import functools
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import smoke_model
from repro_torch.moe import moe_layer, shmap_moe

DATA, MODEL = 2, 2
TOKENS = 128                      # over both data slices
CAPACITY = {"drops": 1.0, "dropless": 8.0}
TOL = 1e-5
SPAWN_TIMEOUT_S = 180
ARCH = "phi3.5-moe-42b-a6.6b"


CHANGE = dict(num_experts=8, experts_per_token=2)


def _cfg(capacity_factor):
    return dataclasses.replace(smoke_model(ARCHS[ARCH]), **CHANGE,
                               capacity_factor=capacity_factor)


def _reference_cfg(capacity_factor):
    from repro.configs.archs import ARCHS as JARCHS
    from repro.configs.base import smoke_model as j_smoke
    return dataclasses.replace(j_smoke(JARCHS[ARCH]), **CHANGE,
                               capacity_factor=capacity_factor)


@functools.lru_cache(maxsize=None)
def _inputs():
    """Reference MoE weights, tokens [TOKENS, d] and loss weights r."""
    import jax
    from repro.moe import moe_layer as JMoE
    jcfg = _reference_cfg(CAPACITY["drops"])
    # compiled without LLVM's optimisations: both packages start from
    # these values, whatever their rounding
    p = jax.jit(lambda k: JMoE.moe_init(jcfg, k)[0], compiler_options={
        "xla_backend_optimization_level": 0})(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((TOKENS, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((TOKENS, jcfg.d_model)).astype(np.float32)
    return {k: np.asarray(v) for k, v in p.items()}, x, r


def _port_moe(cfg, weights):
    p = moe_layer.MoE(cfg, torch.Generator().manual_seed(0))
    p.load_state_dict({k: torch.tensor(v) for k, v in weights.items()})
    return p


def _rank(rank, world, store_path, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)      # ranks share the host's cores
    with np.load(f"{out_dir}/inputs.npz") as f:
        weights = {k[2:]: f[k] for k in f.files if k.startswith("w.")}
        x, r = f["x"], f["r"]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = shmap_moe.make_expert_mesh(DATA, MODEL, device="cpu")
        t = TOKENS // DATA
        sl = slice(mesh.data_rank * t, (mesh.data_rank + 1) * t)
        out = {}
        for case, cf in CAPACITY.items():
            cfg = _cfg(cf)
            p = _port_moe(cfg, weights)
            assert shmap_moe.place_experts(p, mesh) == 1
            y, m = moe_layer.moe_apply(cfg, p, torch.from_numpy(x[sl]),
                                       impl="aam_shmap", mode="train")
            loss = (y * torch.from_numpy(r[sl])).sum() + m["moe_aux"]
            loss.backward()
            grads = shmap_moe.reduce_expert_grads(
                p, mesh, {n: w.grad for n, w in p.named_parameters()})
            for name, g in grads.items():
                out[f"{case}-grad-{name}"] = g.numpy()
            out[f"{case}-y"] = y.detach().numpy()
            out[f"{case}-dropped"] = m["moe_dropped"].numpy()
            out[f"{case}-aux"] = m["moe_aux"].detach().numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _spawn(d):
    # the inputs go through a file: a spawned rank reads its pickled
    # arguments only after it has imported this module, and the pipe holds
    # 64 KiB, so large arguments would start the ranks one after another
    weights, x, r = _inputs()
    np.savez(d / "inputs.npz", x=x, r=r,
             **{f"w.{k}": v for k, v in weights.items()})
    world = DATA * MODEL
    ctx = mp.start_processes(_rank, args=(world, str(d / "store"), str(d)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo run did not finish in "
                            f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """Every rank's results, from one spawn of DATA x MODEL gloo ranks for
    the whole run: under pytest-xdist the first worker to claim the
    run's shared directory spawns the ranks, and the others wait for it."""
    d = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        d = d.parent                       # shared by this run's workers
    d = d / "shmap_gloo"
    d.mkdir(exist_ok=True)
    try:
        os.close(os.open(d / "claimed", os.O_CREAT | os.O_EXCL))
    except FileExistsError:
        deadline = time.monotonic() + SPAWN_TIMEOUT_S + 60
        while not (d / "done").exists():
            if time.monotonic() > deadline:
                pytest.fail("the worker that spawned the gloo run did not "
                            "finish")
            time.sleep(0.2)
    else:
        try:
            _spawn(d)
        finally:
            (d / "done").touch()
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(DATA * MODEL)]


@functools.lru_cache(maxsize=None)
def _reference(case):
    """Per data slice: the reference's aam output, drops and aux; and the
    gradient of the mean over slices of sum(out · r) + aux."""
    import jax
    import jax.numpy as jnp
    from repro.moe import moe_layer as JMoE
    jcfg = _reference_cfg(CAPACITY[case])
    weights, x, r = _inputs()
    t = TOKENS // DATA
    slices = [slice(i * t, (i + 1) * t) for i in range(DATA)]

    def loss(p):
        total = 0.0
        for sl in slices:
            y, m = JMoE.moe_apply_aam(jcfg, p, jnp.asarray(x[sl]))
            total = total + jnp.sum(y * r[sl]) + m["moe_aux"]
        return total / DATA
    p = {k: jnp.asarray(v) for k, v in weights.items()}
    aam = jax.jit(lambda p, x: JMoE.moe_apply_aam(jcfg, p, x))
    outs = [aam(p, jnp.asarray(x[sl])) for sl in slices]
    grads = jax.jit(jax.grad(loss))(p)
    return ([np.asarray(y) for y, _ in outs],
            sum(int(m["moe_dropped"]) for _, m in outs),
            float(np.mean([float(m["moe_aux"]) for _, m in outs])),
            {k: np.asarray(v) for k, v in grads.items()})


@pytest.mark.parametrize("case", list(CAPACITY))
def test_output_matches_aam_per_slice(gloo_results, case):
    ys, dropped, aux, _ = _reference(case)
    if case == "drops":
        assert dropped > 0           # the case must really drop
    for rank, res in enumerate(gloo_results):
        d = rank // MODEL
        np.testing.assert_allclose(res[f"{case}-y"], ys[d], rtol=TOL,
                                   atol=TOL, err_msg=f"rank {rank}")
        assert int(res[f"{case}-dropped"]) == dropped
        np.testing.assert_allclose(float(res[f"{case}-aux"]), aux,
                                   rtol=TOL, atol=TOL)


def test_dropless_output_matches_aam_over_all_tokens(gloo_results):
    import jax
    import jax.numpy as jnp
    from repro.moe import moe_layer as JMoE
    jcfg = _reference_cfg(CAPACITY["dropless"])
    weights, x, _ = _inputs()
    y, m = jax.jit(lambda p, x: JMoE.moe_apply_aam(jcfg, p, x))(
        {k: jnp.asarray(v) for k, v in weights.items()}, jnp.asarray(x))
    assert int(m["moe_dropped"]) == 0
    gathered = np.concatenate([gloo_results[d * MODEL]["dropless-y"]
                               for d in range(DATA)])
    np.testing.assert_allclose(gathered, np.asarray(y), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", list(CAPACITY))
def test_grads_match_reference(gloo_results, case):
    *_, grads = _reference(case)
    for rank, res in enumerate(gloo_results):
        for name, g in grads.items():
            np.testing.assert_allclose(res[f"{case}-grad-{name}"], g,
                                       rtol=0, atol=TOL * np.abs(g).max(),
                                       err_msg=f"rank {rank} {name}")


def test_without_a_mesh_it_is_the_aam_path():
    """``impl="aam_shmap"`` in ``"train"`` on a layer with no mesh runs
    ``moe_apply_aam``; gradients reach every weight."""
    cfg = _cfg(CAPACITY["drops"])
    weights, x, _ = _inputs()
    p = _port_moe(cfg, weights)
    xt = torch.from_numpy(x)
    y, m = moe_layer.moe_apply(cfg, p, xt, impl="aam_shmap", mode="train")
    y0, m0 = moe_layer.moe_apply_aam(cfg, p, xt)
    assert torch.equal(y, y0) and torch.equal(m["moe_dropped"],
                                              m0["moe_dropped"])
    (y.sum() + m["moe_aux"]).backward()
    assert all(w.grad is not None and w.grad.abs().sum() > 0
               for w in p.parameters())
    assert shmap_moe.place_experts(p, None) == 1
