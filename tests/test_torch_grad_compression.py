"""The port's int8 gradient compression (``train/grad_compression.py``)
against the reference's.

* ``_quantize`` gives the reference's int8 payload, scale and residual
  bit for bit on the same inputs;
* over a group of one rank the compressed mean is the dequantised payload
  and the error feedback the residual;
* two gloo ranks (``torch.multiprocessing`` spawn, one torch thread a
  rank) train smoke qwen2 for 25 compressed data-parallel steps, and the
  loss tracks 25 uncompressed steps of the port's ``make_train_step``
  within the reference's 10% (``tests/test_distributed.py``).

The reference package is imported inside the test that runs it: the
spawned ranks import this module, and without JAX they start in half
the time.
"""
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
from repro_torch.data.pipeline import TokenStream
from repro_torch.models import model as M
from repro_torch.train import grad_compression as GC
from repro_torch.train import train_step as T
from repro_torch.train.optimizer import make_optimizer

STEPS = 25
SPAWN_TIMEOUT_S = 180


def _inputs(case):
    rng = np.random.default_rng(7)
    g = rng.standard_normal((7, 13)).astype(np.float32)
    ef = np.zeros_like(g)
    if case == "zeros":
        g = np.zeros_like(g)
    elif case == "feedback":
        ef = (rng.standard_normal(g.shape) * 1e-2).astype(np.float32)
    elif case == "wide":
        g = g * np.logspace(-6, 3, g.size, dtype=np.float32).reshape(g.shape)
    return g, ef


@pytest.mark.parametrize("case", ["normal", "zeros", "feedback", "wide"])
def test_quantize_matches_reference_bit_for_bit(case):
    import jax.numpy as jnp
    from repro.train import grad_compression as JGC
    g, ef = _inputs(case)
    q, scale, err = GC._quantize(torch.from_numpy(g), torch.from_numpy(ef))
    jq, jscale, jerr = JGC._quantize(jnp.asarray(g), jnp.asarray(ef))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.numpy().tobytes() == np.asarray(jscale).tobytes()
    assert err.numpy().tobytes() == np.asarray(jerr).tobytes()


def test_one_rank_mean_is_the_dequantised_payload():
    g, ef = _inputs("feedback")
    grads = {"w": torch.from_numpy(g), "b": torch.ones(3)}
    ef_t = GC.init_error_feedback(grads)
    assert all(torch.equal(e, torch.zeros_like(e)) for e in ef_t.values())
    ef_t["w"] = torch.from_numpy(ef)
    mean, new_ef = GC.compressed_psum_mean(grads, ef_t)
    for k in grads:
        q, scale, err = GC._quantize(grads[k], ef_t[k])
        assert torch.equal(mean[k], q.float() * scale)
        assert torch.equal(new_ef[k], err)


def _run_config():
    cfg = smoke_model(ARCHS["qwen2-1.5b"])
    return cfg, RunConfig(model=cfg, shape=ShapeConfig("t", 64, 8, "train"),
                          remat="none", learning_rate=1e-3)


def _rank(rank, world, store_path, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)      # ranks share the host's cores
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        cfg, rcfg = _run_config()
        model, params, opt_state = T.init_train_state(cfg, rcfg,
                                                      device="cpu")
        opt = make_optimizer(rcfg)
        step = GC.make_compressed_dp_step(
            lambda p, b: M.loss_fn(cfg, rcfg, model, b), opt,
            dist.group.WORLD)
        ef = GC.init_error_feedback(params)
        stream = TokenStream(cfg, rcfg.shape, seed=0)
        per = rcfg.shape.global_batch // world
        for i in range(STEPS):
            batch = {k: torch.from_numpy(v[rank * per:(rank + 1) * per])
                     for k, v in stream.batch(i).items()}
            params, opt_state, ef, loss = step(params, opt_state, ef, i,
                                               batch)
        np.savez(f"{out_dir}/rank{rank}.npz", loss=loss.numpy(),
                 w=params["layers.0.mlp.wi"].detach().numpy())
    finally:
        dist.destroy_process_group()


def test_compressed_dp_tracks_uncompressed_loss(tmp_path):
    world = 2
    ctx = mp.start_processes(_rank, args=(world, str(tmp_path / "store"),
                                          str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, rcfg = _run_config()
        model, params, opt_state = T.init_train_state(cfg, rcfg,
                                                      device="cpu")
        step = T.make_train_step(cfg, rcfg, model)
        stream = TokenStream(cfg, rcfg.shape, seed=0)
        for i in range(STEPS):
            params, opt_state, metrics = step(params, opt_state, i,
                                              stream.batch(i))
        base = metrics["loss"].item()
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo run did not finish in "
                            f"{SPAWN_TIMEOUT_S} s")
    finally:
        torch.set_num_threads(n)
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    # replicated state: both ranks applied the same mean
    np.testing.assert_array_equal(ranks[0]["w"], ranks[1]["w"])
    assert float(ranks[0]["loss"]) == float(ranks[1]["loss"])
    comp = float(ranks[0]["loss"])
    assert abs(comp - base) / base < 0.10, (comp, base)
