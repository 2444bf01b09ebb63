"""The port's training stack against the reference package, on the CPU.

Same numpy-seeded inputs and the reference's weights carried over by
``repro_torch.convert``, at smoke width with f32 compute:

* ``TokenStream`` batches bit for bit (whisper's frames and the vlm's
  patch embeddings included);
* ``loss_fn``'s loss (rtol 1e-5) and every gradient leaf (rtol 1e-4 /
  atol 1e-6) against ``jax.value_and_grad`` for the dense, MoE ``aam``,
  SSM, vlm and enc-dec families under each ``remat`` (remat changes no
  value in the reference, so it runs once per family and run, at
  ``"none"``, shared by the run's pytest-xdist workers); whisper is held
  to a bf16 bound (below);
* one AdamW and one Adafactor update from the same gradients (params and
  state within atol 1e-6), the microbatched gradients at 4 microbatches,
  the global-norm clip;
* the reference's own system checks on the port: the three loss curves of
  ``tests/test_system.py``, exact checkpoint resume (loss 1e-4, params
  1e-5), ``TrainSupervisor`` restores, the launcher resumes;
* ``input_specs``, ``cache_specs`` and ``param_specs`` for every (arch,
  ``SHAPES``) cell.

The whisper bound: the reference runs the cross-attention K/V in bf16
even at f32 compute (``encdec._cross_kv``), so in both packages the
decoder reads bf16-rounded encoder states and the gradient reaching the
encoder passes through a bf16 cotangent.  An f32 rounding difference in
front of either cast can move one bf16 rounding by one step (2**-8 of the
value), which shows in every leaf of the model: the decoder's in the
forward, the encoder's in the backward.  So each whisper leaf is held
within 2**-8 of its largest gradient (the loss keeps rtol 1e-5).
"""
import dataclasses
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.archs import ARCHS as JARCHS
from repro.configs.base import (SHAPES as JSHAPES, RunConfig as JRunConfig,
                                ShapeConfig as JShapeConfig,
                                smoke_model as j_smoke)
from repro.data.pipeline import TokenStream as JTokenStream
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train import train_step as JT
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import (SHAPES, RunConfig, ShapeConfig,
                                      smoke_model)
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.runtime.fault_tolerance import (TrainSupervisor,
                                                 device_get,
                                                 restore_template)
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as T

FAMILIES = {"dense": "qwen2-1.5b", "moe": "phi3.5-moe-42b-a6.6b",
            "ssm": "mamba2-780m", "vlm": "pixtral-12b",
            "encdec": "whisper-small"}
SHAPE = (2, 32)                  # batch x seq of the gradient parity cases
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
BF16_STEP = 2.0 ** -8
QUICK_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each
    (a worker's default of one thread per core makes the port's small
    ops several times slower under the suite's load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _configs(arch, shape=SHAPE, **run):
    """(reference cfg, reference rcfg, port cfg, port rcfg), f32 compute."""
    b, s = shape
    jcfg, cfg = j_smoke(JARCHS[arch]), smoke_model(ARCHS[arch])
    run = dict(dict(remat="none", compute_dtype="float32"), **run)
    return (jcfg, JRunConfig(model=jcfg, shape=JShapeConfig("t", s, b,
                                                            "train"), **run),
            cfg, RunConfig(model=cfg, shape=ShapeConfig("t", s, b, "train"),
                           **run))


def _port_model(cfg, jparams):
    model = M.init(cfg, device="cpu")
    model.load_state_dict(convert.to_params(cfg, _np(jparams),
                                            device="cpu"))
    return model


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """``get(key, compute)``: ``compute()``, computed once for the whole
    run: under pytest-xdist the first worker to claim ``key`` computes it
    into the run's shared directory (a pickle this test wrote) and the
    others read it."""
    d = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        d = d.parent                       # shared by this run's workers
    d = d / "torch_train_reference"
    d.mkdir(exist_ok=True)
    seen = {}

    def get(key, compute):
        if key in seen:
            return seen[key]
        out, done = d / f"{key}.pkl", d / f"{key}.done"
        try:
            os.close(os.open(d / f"{key}.claimed", os.O_CREAT | os.O_EXCL))
        except FileExistsError:
            deadline = time.monotonic() + 600
            while not done.exists():
                if time.monotonic() > deadline:
                    pytest.fail(f"no reference for {key}")
                time.sleep(0.1)
        else:
            try:
                out.write_bytes(pickle.dumps(compute()))
            finally:
                done.touch()
        seen[key] = pickle.loads(out.read_bytes())
        return seen[key]
    return get


def _reference_params(shared, arch, layers=None):
    """The reference's smoke-width params from key 0 (``layers`` replaces
    the depth), as numpy, one jitted init per run (compiled without
    LLVM's optimisations: both packages start from its values, whatever
    their rounding)."""
    def compute():
        jcfg = j_smoke(JARCHS[arch])
        if layers:
            jcfg = dataclasses.replace(jcfg, num_layers=layers)
        return _np(jax.jit(lambda k: JM.init(jcfg, k)[0],
                           compiler_options=QUICK_COMPILE)(
            jax.random.PRNGKey(0)))
    return shared(f"params-{arch}-{layers}", compute)


@pytest.fixture(scope="module")
def reference_grads(shared):
    """``get(family)``: the reference's (params, batch, loss, metrics,
    grads) for a family, computed once for the whole run."""
    def compute(family):
        jcfg, jrcfg, _, _ = _configs(FAMILIES[family])
        params = _reference_params(shared, FAMILIES[family])
        batch = JTokenStream(jcfg, jrcfg.shape, seed=0).batch(0)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b: JM.loss_fn(jcfg, jrcfg, p, b), has_aux=True))(
                params, jax.tree.map(jnp.asarray, batch))
        return params, batch, float(loss), _np(metrics), _np(grads)
    return lambda family: shared(f"grads-{family}",
                                 lambda: compute(family))


def _assert_grads(cfg, got, exp_tree, *, bf16=False):
    exp = convert.to_params(cfg, exp_tree, device="cpu")
    assert got.keys() == exp.keys()
    for k, e in exp.items():
        g = got[k].float()
        if bf16:
            bound = BF16_STEP * float(e.abs().max())
            assert float((g - e).abs().max()) <= bound, k
        else:
            torch.testing.assert_close(g, e, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       msg=lambda m, k=k: f"{k}: {m}")


# -- the token stream -------------------------------------------------------


@pytest.mark.parametrize("arch,host", [("qwen2-1.5b", (0, 1)),
                                       ("whisper-small", (1, 2)),
                                       ("pixtral-12b", (0, 2))])
def test_token_stream_is_bit_identical(arch, host):
    jcfg, jrcfg, cfg, rcfg = _configs(arch, (4, 24))
    js = JTokenStream(jcfg, jrcfg.shape, seed=3)
    ts = TokenStream(cfg, rcfg.shape, seed=3)
    for step in (0, 5):
        exp = js.batch(step, host_id=host[0], num_hosts=host[1])
        got = ts.batch(step, host_id=host[0], num_hosts=host[1])
        assert got.keys() == exp.keys()
        for k in exp:
            assert got[k].dtype == exp[k].dtype, k
            np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
        on = ts.tensors(step, host_id=host[0], num_hosts=host[1],
                        device="cpu")
        for k in exp:
            np.testing.assert_array_equal(on[k].numpy(), exp[k], err_msg=k)


# -- loss and gradients -----------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_reference(family, remat, reference_grads):
    params, batch, loss, metrics, grads = reference_grads(family)
    _, _, cfg, rcfg = _configs(FAMILIES[family], remat=remat)
    model = _port_model(cfg, params)
    got, got_loss, got_metrics = T.grads_fn(cfg, rcfg, model, _t(batch))
    np.testing.assert_allclose(got_loss.item(), loss, rtol=LOSS_RTOL)
    assert got_metrics.keys() == metrics.keys()
    for k, v in metrics.items():
        np.testing.assert_allclose(got_metrics[k].item(), v,
                                   rtol=LOSS_RTOL, err_msg=k)
    _assert_grads(cfg, got, grads, bf16=family == "encdec")


def test_remat_runs_the_moe_plan_again(shared):
    """Under ``remat="full"`` the backward recomputes each MoE layer, so
    the bucket count runs twice per MoE layer; with ``"none"`` once."""
    from repro_torch.kernels import coalesce
    jcfg, jrcfg, _, _ = _configs(FAMILIES["moe"])
    params = _reference_params(shared, FAMILIES["moe"])
    batch = JTokenStream(jcfg, jrcfg.shape, seed=0).batch(0)
    counts = {}
    real = coalesce.bucket_count_ref

    def counting(owner, num_buckets):
        counts[remat] = counts.get(remat, 0) + 1
        return real(owner, num_buckets)
    for remat in ("none", "full"):
        _, _, cfg, rcfg = _configs(FAMILIES["moe"], remat=remat)
        model = _port_model(cfg, params)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(coalesce, "bucket_count_ref", counting)
            T.grads_fn(cfg, rcfg, model, _t(batch))
    moe_layers = sum(s.mlp == "moe" for s in cfg.full_pattern)
    assert counts == {"none": moe_layers, "full": 2 * moe_layers}


# -- optimizers, microbatching, clipping ------------------------------------


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch,layers", [("qwen2-1.5b", 3),
                                         ("phi3.5-moe-42b-a6.6b", None),
                                         ("whisper-small", None)])
def test_optimizer_update_matches_reference(opt, arch, layers, shared):
    """Two updates from the same gradients (random, with the params'
    shapes): after the first the reference's state carried over by
    ``convert.to_opt_state`` equals the port's; the second starts from
    it.  qwen2 at 3 layers stacks every layer leaf over 3 blocks, so
    Adafactor's factors and clip run over the stack."""
    jcfg, jrcfg, cfg, rcfg = _configs(arch, optimizer=opt,
                                      learning_rate=1e-2)
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, num_layers=layers)
        jrcfg = dataclasses.replace(jrcfg, model=jcfg)
        rcfg = dataclasses.replace(rcfg, model=cfg)
    jopt, topt = JO.make_optimizer(jrcfg), O.make_optimizer(rcfg)
    params = _reference_params(shared, arch, layers)
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32) * 0.01, params) for _ in range(2)]
    model = _port_model(cfg, params)
    tp = dict(model.named_parameters())
    jstate, tstate = jopt.init(params), topt.init(tp)
    for step in range(2):
        params, jstate = jax.jit(jopt.update)(
            jax.tree.map(jnp.asarray, grads[step]), jstate, params,
            jnp.int32(step))
        tp, tstate = topt.update(convert.to_params(cfg, grads[step],
                                                   device="cpu"),
                                 tstate, tp, step)
        for k, e in convert.to_params(cfg, _np(params),
                                      device="cpu").items():
            torch.testing.assert_close(tp[k].detach(), e, rtol=0, atol=1e-6,
                                       msg=lambda m, k=k: f"{k}: {m}")
        exp_state = convert.to_opt_state(cfg, _np(jstate), device="cpu")
        flat = lambda s: {f"{a}.{b}": t for a, sub in s.items()
                          for b, t in sub.items()}
        got, exp = flat(tstate), flat(exp_state)
        assert got.keys() == exp.keys()
        for k in exp:
            torch.testing.assert_close(got[k], exp[k], rtol=0, atol=1e-6,
                                       msg=lambda m, k=k: f"{k}: {m}")
        tstate = exp_state          # the second update starts from it


def test_microbatched_grads_match_reference(shared):
    jcfg, jrcfg, cfg, rcfg = _configs("qwen2-1.5b", (8, 32), microbatches=4)
    params = _reference_params(shared, "qwen2-1.5b")
    batch = JTokenStream(jcfg, jrcfg.shape, seed=0).batch(0)
    g, loss, metrics = jax.jit(lambda p, b: JT.grads_fn(jcfg, jrcfg, p, b))(
        params, jax.tree.map(jnp.asarray, batch))
    got, got_loss, got_metrics = T.grads_fn(cfg, rcfg,
                                            _port_model(cfg, params),
                                            _t(batch))
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=LOSS_RTOL)
    for k, v in _np(metrics).items():
        assert got_metrics[k].dtype == torch.float32
        np.testing.assert_allclose(got_metrics[k].item(), v, rtol=LOSS_RTOL,
                                   err_msg=k)
    _assert_grads(cfg, got, _np(g))


def test_clip_matches_reference():
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((8, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32) * 3}}
    flat = {"a": torch.from_numpy(tree["a"]),
            "b.c": torch.from_numpy(tree["b"]["c"])}
    for max_norm in (1.0, 100.0):
        exp, jnorm = JT.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                            max_norm)
        got, norm = T.clip_by_global_norm(
            {k: v.clone() for k, v in flat.items()}, max_norm)
        np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
        np.testing.assert_allclose(got["a"].numpy(), exp["a"], rtol=1e-6)
        np.testing.assert_allclose(got["b.c"].numpy(), exp["b"]["c"],
                                   rtol=1e-6)


# -- the reference's system checks, on the port -----------------------------


def _train(cfg, rcfg, steps, *, model=None, params=None, opt_state=None,
           start=0, seed=0):
    if model is None:
        model, params, opt_state = T.init_train_state(cfg, rcfg, seed=seed,
                                                      device="cpu")
    step = T.make_train_step(cfg, rcfg, model)
    stream = TokenStream(cfg, rcfg.shape, seed=seed)
    losses = []
    for i in range(start, steps):
        params, opt_state, metrics = step(params, opt_state, i,
                                          stream.batch(i))
        losses.append(metrics["loss"].item())
    return model, params, opt_state, losses


def _assert_learning(losses):
    first = sum(losses[:5]) / 5
    last = sum(losses[-5:]) / 5
    assert last < first - 0.05, (first, last, losses[::6])


@pytest.mark.parametrize("arch,lr,steps", [
    ("qwen2-1.5b", 1e-3, 25),              # test_loss_decreases_dense
    ("phi3.5-moe-42b-a6.6b", 3e-3, 30),    # ..._moe_aam_path
    ("mamba2-780m", 3e-3, 30)])            # ..._ssm
def test_loss_decreases(arch, lr, steps):
    cfg = smoke_model(ARCHS[arch])
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", 64, 8, "train"),
                     remat="none", learning_rate=lr, moe_impl="aam")
    *_, losses = _train(cfg, rcfg, steps)
    assert all(np.isfinite(losses))
    _assert_learning(losses)


def _resume_config():
    cfg = smoke_model(ARCHS["qwen2-1.5b"])
    return cfg, RunConfig(model=cfg, shape=ShapeConfig("t", 32, 4, "train"),
                          remat="none", learning_rate=1e-3)


def test_checkpoint_resume_is_exact(tmp_path):
    """Resume mid-run == uninterrupted run (deterministic data + state),
    within the reference's bounds."""
    cfg, rcfg = _resume_config()
    _, p_full, _, losses_full = _train(cfg, rcfg, 12)
    model, p6, o6, _ = _train(cfg, rcfg, 6)
    ck = Checkpointer(tmp_path)
    ck.save(6, (p6, o6))
    template, device = restore_template((p6, o6))
    (p6r, o6r), start = ck.restore(template, device=device)
    assert start == 6 and all(t.device.type == "cpu" for t in p6r.values())
    fresh, *_ = T.init_train_state(cfg, rcfg, seed=5, device="cpu")
    _, p_res, _, losses_res = _train(cfg, rcfg, 12, model=fresh, params=p6r,
                                     opt_state=o6r, start=start)
    assert abs(losses_res[-1] - losses_full[-1]) < 1e-4
    for k, a in p_full.items():
        np.testing.assert_allclose(a.detach().numpy(),
                                   p_res[k].detach().numpy(), atol=1e-5)


def test_port_resumes_from_a_reference_checkpoint(tmp_path, shared):
    """A step the reference's ``Checkpointer`` wrote (its params and AdamW
    state after 3 steps) resumes in the port: the next step's loss equals
    the reference's."""
    jcfg, jrcfg, cfg, rcfg = _configs("qwen2-1.5b", (4, 32))
    jopt = JO.make_optimizer(jrcfg)
    params = _reference_params(shared, "qwen2-1.5b")
    state = jopt.init(params)
    step = jax.jit(JT.make_train_step(jcfg, jrcfg, jopt))
    stream = JTokenStream(jcfg, jrcfg.shape, seed=0)
    for i in range(4):
        if i == 3:
            JCheckpointer(tmp_path).save(3, {"params": params,
                                             "opt": state})
        params, state, metrics = step(params, state, jnp.int32(i),
                                      jax.tree.map(jnp.asarray,
                                                   stream.batch(i)))
    saved = JCheckpointer(tmp_path).restore(
        jax.eval_shape(lambda: {"params": params, "opt": state}))[0]
    model = _port_model(cfg, saved["params"])
    tstate = convert.to_opt_state(cfg, _np(saved["opt"]), device="cpu")
    tp = dict(model.named_parameters())
    _, _, got = T.make_train_step(cfg, rcfg, model)(
        tp, tstate, 3, TokenStream(cfg, rcfg.shape, seed=0).batch(3))
    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]),
                               rtol=LOSS_RTOL)
    assert got["step"] == 4


def test_train_supervisor_replays_a_fault_exactly(tmp_path):
    """8 steps, a save every 4 and a fault at step 6, against the same 8
    steps uninterrupted: one restart, params within the reference's
    resume bound."""
    cfg, rcfg = _resume_config()
    _, p_full, _, _ = _train(cfg, rcfg, 8)
    model, params, opt_state = T.init_train_state(cfg, rcfg, device="cpu")
    step_fn = T.make_train_step(cfg, rcfg, model)
    stream = TokenStream(cfg, rcfg.shape, seed=0)
    fired = []

    def injector(step):
        if step == 6 and not fired:
            fired.append(step)
            raise RuntimeError("node lost")

    def run_step(state, step, batch):
        p, o, m = step_fn(*state, step, batch)
        return (p, o), m
    sup = TrainSupervisor(Checkpointer(tmp_path), save_every=4)
    (params, _), final, log = sup.run(
        (params, opt_state), run_step, stream.batch, start_step=0,
        num_steps=8, fail_injector=injector, log_every=4,
        log=lambda *_: None)
    assert (final, sup.restarts) == (8, 1)
    assert [s for s, _ in log] == [4, 8]
    assert isinstance(log[-1][1]["loss"], float) and log[-1][1]["step"] == 8
    for k, a in p_full.items():
        np.testing.assert_allclose(a.detach().numpy(),
                                   params[k].detach().numpy(), atol=1e-5)


def test_supervisor_restores_after_injected_failure(tmp_path):
    """The reference's ``test_checkpoint_ft`` case on the port."""
    ck = Checkpointer(tmp_path)
    state0 = {"w": torch.zeros(4), "n": torch.tensor(0, dtype=torch.int32)}
    ck.save(0, state0)

    def step_fn(state, step, batch):
        return ({"w": state["w"] + 1.0, "n": state["n"] + 1},
                {"loss": float(step)})

    failed = {"done": False}

    def injector(step):
        if step == 7 and not failed["done"]:
            failed["done"] = True
            raise RuntimeError("node lost")

    sup = TrainSupervisor(ck, save_every=5, max_restarts=3)
    state, final, _ = sup.run(state0, step_fn, lambda s: None,
                              start_step=0, num_steps=12,
                              fail_injector=injector, log=lambda *_: None)
    assert final == 12 and sup.restarts == 1
    # replay from the step-5 checkpoint: w counts every step exactly once
    assert float(state["w"][0]) == 12.0 and state["n"].dtype == torch.int32

    def bad_step(state, step, batch):
        raise RuntimeError("always broken")
    ck = Checkpointer(tmp_path / "broken")
    ck.save(0, state0)
    sup = TrainSupervisor(ck, save_every=100, max_restarts=2)
    with pytest.raises(RuntimeError):
        sup.run(state0, bad_step, lambda s: None, start_step=0,
                num_steps=5, log=lambda *_: None)


def test_supervisor_restores_a_save_still_being_written(tmp_path,
                                                        monkeypatch):
    """A fault that comes while the only save is still being written in
    the background: the supervisor drains it and restores from it (steps
    on a card can end long before the write does)."""
    ck = Checkpointer(tmp_path)
    write = Checkpointer._write_leaves

    def slow_write(d, leaves):
        time.sleep(0.3)
        return write(d, leaves)
    monkeypatch.setattr(Checkpointer, "_write_leaves",
                        staticmethod(slow_write))
    fired = []

    def injector(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("node lost")

    def step_fn(state, step, batch):
        return {"w": state["w"] + 1.0}, {}
    sup = TrainSupervisor(ck, save_every=2)
    state, final, _ = sup.run({"w": torch.zeros(3)}, step_fn,
                              lambda s: None, start_step=0, num_steps=5,
                              fail_injector=injector, log=lambda *_: None)
    assert (final, sup.restarts) == (5, 1)
    assert torch.equal(state["w"], torch.full((3,), 5.0))


def test_async_saves_keep_the_step_they_were_given(tmp_path):
    """The optimizers update the state in place while a background save
    of an earlier step may still be writing it: each kept step must hold
    its own values."""
    ck = Checkpointer(tmp_path, keep=4)

    def step_fn(state, step, batch):
        state["w"].add_(1.0)
        return state, {}
    sup = TrainSupervisor(ck, save_every=1)
    sup.run({"w": torch.zeros(1 << 20)}, step_fn, lambda s: None,
            start_step=0, num_steps=12, log=lambda *_: None)
    template = {"w": torch.empty(1 << 20, device="meta")}
    for step in ck.all_steps():
        got, _ = ck.restore(template, step, device="cpu")
        assert torch.equal(got["w"], torch.full((1 << 20,), float(step)))


def test_restore_template_and_device_get():
    state = ({"w": torch.ones(3, 2)}, [torch.tensor(2, dtype=torch.int32)],
             np.zeros(4, np.float32))
    template, device = restore_template(state)
    assert device == torch.device("cpu")
    assert template[0]["w"].device.type == "meta"
    assert (template[0]["w"].shape, template[2].dtype) == ((3, 2),
                                                          torch.float32)
    got = device_get({"loss": torch.tensor(1.5), "n": torch.tensor(
        3, dtype=torch.int32), "v": torch.arange(3), "step": 7})
    assert got == {"loss": 1.5, "n": 3.0, "v": got["v"], "step": 7}
    np.testing.assert_array_equal(got["v"], [0, 1, 2])


def test_train_profile_refuses_to_run_without_a_card(capsys):
    from repro_torch.obs import train_profile
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert train_profile.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_train_launcher_runs_and_resumes_on_cpu(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--save-every", "2", "--ckpt-dir", str(tmp_path)]
    first = launch_train.main(argv + ["--steps", "4"])
    assert (first["start"], first["final"]) == (0, 4)
    second = launch_train.main(argv + ["--steps", "6"])
    assert (second["start"], second["final"]) == (4, 6)
    assert np.isfinite(second["log"][-1][1]["loss"])
    out = capsys.readouterr().out
    assert "[launch] resumed from step 4" in out
    # the production mesh needs its 256 ranks (torchrun); here is one
    with pytest.raises(ValueError, match="needs world size 256"):
        launch_train.main(argv + ["--production-mesh"])


# -- the dry-run contract ---------------------------------------------------


def _spec_tree(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_and_cache_specs_match_reference(arch, shape):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    rcfg = RunConfig(model=cfg, shape=SHAPES[shape])
    jrcfg = JRunConfig(model=jcfg, shape=JSHAPES[shape])
    got = M.input_specs(cfg, SHAPES[shape])
    exp = JM.input_specs(jcfg, JSHAPES[shape])
    assert all(v.device.type == "meta" for v in got.values())
    assert _spec_tree(got) == {k: (tuple(v.shape), str(v.dtype))
                               for k, v in exp.items()}
    if SHAPES[shape].kind != "decode":
        return
    got = M.cache_specs(cfg, rcfg, SHAPES[shape])
    exp = JM.cache_specs(jcfg, jrcfg, JSHAPES[shape])
    got_l, _ = jax.tree_util.tree_flatten(got)
    exp_l, _ = jax.tree_util.tree_flatten(exp)
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in got_l] == [(tuple(s.shape), str(s.dtype)) for s in exp_l]
    assert all(t.device.type == "meta" for t in got_l)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch):
    """Each stacked leaf of the reference ([blocks or layers, ...]) is one
    port entry per layer of the per-layer shape, under the names
    ``convert`` maps it to."""
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    got = M.param_specs(cfg)
    assert all(v.device.type == "meta" for v in got.values())
    exp = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            JM.param_specs(jcfg))[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        leaf = ".".join(str(k) for k in keys[2:])
        if keys[0] == "blocks":
            n = len(cfg.full_pattern)
            for j in range(s.shape[0]):
                exp[f"layers.{j * n + keys[1]}.{leaf}"] = s.shape[1:]
        elif keys[0] in ("encoder", "decoder"):
            for l in range(s.shape[0]):
                exp[f"{keys[0]}.{l}.{'.'.join(map(str, keys[1:]))}"] = \
                    s.shape[1:]
        else:
            exp[".".join(map(str, keys))] = s.shape
        assert str(s.dtype) == "float32"
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v) for k, v in exp.items()}
    assert {v.dtype for v in got.values()} == {torch.float32}
