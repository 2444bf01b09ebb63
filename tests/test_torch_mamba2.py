"""The port's Mamba2 serving path against the reference's, on the CPU.

Weights come from the reference's init and are carried over (the mixer's
as they are, the LM's by :func:`repro_torch.convert.to_lm_params`);
prompts and activations are drawn with numpy from a seed.  Tolerances:

* mixer (``ssm_apply``, ``ssm_decode``, ``ssm_ref``), f32: atol 1e-4
  relative to the largest output (outputs are of order 1);
* LM logits and the f32 SSM cache: atol 1e-4 relative to the largest
  logit (entry) in f32, 0.05 relative in bf16 (the two frameworks round
  bf16 products at other places);
* the conv cache, which both packages store in bf16: one bf16 ulp
  (rtol 2**-8) in f32, 0.05 relative in bf16;
* greedy tokens, f32 only: equal at every step up to the first whose
  reference top-2 margin is within the logit tolerance (a near-tie may
  break either way, and the sequences may part after it).

The reference runs its einsum path and, where marked, its Pallas kernel
in interpret mode; the port runs its kernel wrapper (the plain version on
the CPU) or its einsum path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as J_ARCHS
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import smoke_model as j_smoke
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.serve.serve_step import generate as j_generate
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
from repro_torch.convert import to_lm_params
from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.serve.serve_step import generate

ARCH = "mamba2-780m"
J_CFG = dataclasses.replace(j_smoke(J_ARCHS[ARCH]), num_layers=2)
CFG = dataclasses.replace(smoke_model(ARCHS[ARCH]), num_layers=2)
V = CFG.vocab_size
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.05}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each
    (a worker's default of one thread per core makes the port's small
    ops several times slower under the suite's load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_rel(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: |diff| {err} > {tol} x {scale}"


# --------------------------------------------------------------------------
# the mixer, at smoke width (d 64, 8 heads of 16, state 16)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixer():
    cfg = smoke_model(ARCHS[ARCH])
    jp, _ = jssm.ssm_init(j_smoke(J_ARCHS[ARCH]), jax.random.PRNGKey(1))
    p = ssm.Mamba2Mixer(cfg, torch.Generator().manual_seed(0))
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    return cfg, jp, p


def _x(b, s, d, seed):
    return np.random.default_rng(seed).normal(size=(b, s, d)) \
        .astype(np.float32)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("s", [24, 32, 131])
@pytest.mark.parametrize("chunk", [8, 16])
def test_ssm_apply_matches_reference(mixer, chunk, s, use_pallas):
    """S = 131 is prime: chunks of 1 row, 131 of them."""
    cfg, jp, p = mixer
    x = _x(2, s, cfg.d_model, seed=s + chunk)
    jy, (jconv, jh) = jssm.ssm_apply(J_CFG, jp, jnp.asarray(x), chunk=chunk)
    before = ssd_chunk_kernel.launches
    y, (conv, h) = ssm.ssm_apply(cfg, p, torch.from_numpy(x), chunk=chunk,
                                 use_pallas=use_pallas)
    assert ssd_chunk_kernel.launches == before      # the CPU runs no kernel
    _close_rel(y, jy, 1e-4, "out")
    _close_rel(conv, jconv, 1e-4, "conv state")
    _close_rel(h, jh, 1e-4, "ssm state")


def test_ssm_apply_matches_reference_pallas_interpret(mixer):
    cfg, jp, p = mixer
    x = _x(2, 32, cfg.d_model, seed=5)
    jy, (_, jh) = jssm.ssm_apply(J_CFG, jp, jnp.asarray(x), chunk=8,
                                 use_pallas=True)
    y, (_, h) = ssm.ssm_apply(cfg, p, torch.from_numpy(x), chunk=8,
                              use_pallas=True)
    _close_rel(y, jy, 1e-4, "out")
    _close_rel(h, jh, 1e-4, "ssm state")


def test_ssm_decode_matches_reference(mixer):
    cfg, jp, p = mixer
    rng = np.random.default_rng(3)
    x = _x(2, 1, cfg.d_model, seed=4)
    conv = rng.normal(size=(2, cfg.ssm_conv_kernel - 1, cfg.d_inner
                            + 2 * cfg.ssm_state)).astype(np.float32)
    h = rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state)).astype(np.float32)
    jy, (jconv, jh) = jssm.ssm_decode(J_CFG, jp, *map(jnp.asarray,
                                                      (x, conv, h)))
    y, (conv2, h2) = ssm.ssm_decode(cfg, p, *map(torch.from_numpy,
                                                 (x, conv, h)))
    _close_rel(y, jy, 1e-4, "out")
    _close_rel(conv2, jconv, 1e-4, "conv state")
    _close_rel(h2, jh, 1e-4, "ssm state")


@pytest.mark.parametrize("s", [24, 131])
def test_ssm_ref_matches_reference_and_chunked_form(mixer, s):
    cfg, jp, p = mixer
    x = _x(2, s, cfg.d_model, seed=s)
    y = ssm.ssm_ref(cfg, p, torch.from_numpy(x))
    _close_rel(y, jssm.ssm_ref(J_CFG, jp, jnp.asarray(x)), 1e-4, "ref")
    y_chunk, _ = ssm.ssm_apply(cfg, p, torch.from_numpy(x), chunk=16,
                               use_pallas=True)
    _close_rel(y_chunk, y, 1e-4, "chunked vs sequential")


# --------------------------------------------------------------------------
# the slice: a 2-layer smoke Mamba2 through prefill, decode and generate
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    params, _ = JM.init(J_CFG, jax.random.PRNGKey(0))
    model = M.init(CFG, 0, device="cpu")
    model.load_state_dict(to_lm_params(CFG, jax.tree.map(np.asarray, params),
                                       device="cpu"))
    return params, model


def _rcfgs(dtype, use_pallas, s):
    return (JRunConfig(model=J_CFG, shape=JShapeConfig("t", s, 2, "prefill"),
                       compute_dtype=dtype, use_pallas=use_pallas),
            RunConfig(model=CFG, shape=ShapeConfig("t", s, 2, "prefill"),
                      compute_dtype=dtype, use_pallas=use_pallas))


def _prompt(s, seed=0):
    return np.random.default_rng(seed).integers(0, V, (2, s)) \
        .astype(np.int32)


def test_to_lm_params_maps_every_layer(lm):
    params, model = lm
    mix = params["blocks"][0]["mixer"]
    for j in range(CFG.num_layers):
        np.testing.assert_array_equal(
            model.layers[j].mixer.wz.detach().numpy(),
            np.asarray(mix["wz"][j]))
    assert sum(t.numel() for t in model.parameters()) == sum(
        np.size(a) for a in jax.tree.leaves(params))


# prompt 200 -> chunks of 100 (two per sequence); the Pallas kernel of
# the reference runs in interpret mode on the use_pallas cases
CASES = [("float32", False), ("float32", True), ("bfloat16", False),
         ("bfloat16", True)]


@pytest.mark.parametrize("dtype,use_pallas", CASES)
def test_prefill_matches_reference(lm, dtype, use_pallas):
    params, model = lm
    jr, tr = _rcfgs(dtype, use_pallas, 200)
    toks = _prompt(200)
    jl, jcache = JM.prefill(J_CFG, jr, params, {"tokens": jnp.asarray(toks)})
    tl, tcache = M.prefill(CFG, tr, model, {"tokens": torch.from_numpy(toks)})
    tol = LOGIT_TOL[dtype]
    assert tl.shape == (2, 1, CFG.padded_vocab)
    np.testing.assert_array_equal(_np(tl)[..., V:], _np(jl)[..., V:])
    _close_rel(_np(tl)[..., :V], _np(jl)[..., :V], tol, "logits")
    assert [sorted(e) for e in tcache] == [sorted(e) for e in jcache]
    conv, jconv = tcache[0]["conv"], jcache[0]["conv"]
    assert conv.dtype == torch.bfloat16 and jconv.dtype == jnp.bfloat16
    assert tcache[0]["ssm"].dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(_np(conv), _np(jconv), rtol=2 ** -8,
                                   atol=0)
    else:
        _close_rel(conv, jconv, tol, "conv cache")
    _close_rel(tcache[0]["ssm"], jcache[0]["ssm"], tol, "ssm cache")


@pytest.mark.parametrize("dtype,use_pallas", CASES[::2])
def test_decode_steps_match_reference(lm, dtype, use_pallas):
    """8 decode steps from the prefill's cache, both fed the reference's
    greedy tokens."""
    params, model = lm
    jr, tr = _rcfgs(dtype, use_pallas, 40)
    toks = _prompt(32, seed=1)
    jl, jcache = JM.prefill(J_CFG, jr, params, {"tokens": jnp.asarray(toks)})
    _, tcache = M.prefill(CFG, tr, model, {"tokens": torch.from_numpy(toks)})
    for i in range(8):
        tok = np.argmax(_np(jl), axis=-1).astype(np.int32)
        jl, jcache = JM.decode_step(J_CFG, jr, params, jcache,
                                    jnp.asarray(tok), jnp.int32(32 + i))
        tl, tcache = M.decode_step(CFG, tr, model, tcache,
                                   torch.from_numpy(tok), 32 + i)
        _close_rel(_np(tl)[..., :V], _np(jl)[..., :V], LOGIT_TOL[dtype],
                   f"decode step {i}")
    _close_rel(tcache[0]["ssm"], jcache[0]["ssm"], LOGIT_TOL[dtype],
               "ssm cache")
    assert tcache[0]["conv"].dtype == getattr(torch, dtype)


def test_decode_from_init_cache_matches_reference(lm):
    params, model = lm
    jr, tr = _rcfgs("float32", False, 4)
    jcache = JM.init_cache(J_CFG, jr, 2, 4)
    tcache = M.init_cache(CFG, tr, 2, 4, device="cpu")
    for e, je in zip(tcache, jcache):
        for k in je:
            assert tuple(e[k].shape) == je[k].shape
            assert str(e[k].dtype)[6:] == str(je[k].dtype)
    tok = _prompt(1, seed=2)
    jl, _ = JM.decode_step(J_CFG, jr, params, jcache, jnp.asarray(tok),
                           jnp.int32(0))
    tl, _ = M.decode_step(CFG, tr, model, tcache, torch.from_numpy(tok), 0)
    _close_rel(_np(tl)[..., :V], _np(jl)[..., :V], 1e-4, "logits")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_generate_matches_reference_greedy(lm, use_pallas):
    params, model = lm
    jr, tr = _rcfgs("float32", use_pallas, 48)
    toks, n_new = _prompt(40, seed=3), 8
    want = np.asarray(j_generate(J_CFG, jr, params,
                                 {"tokens": jnp.asarray(toks)},
                                 max_new_tokens=n_new))
    got = generate(CFG, tr, model, {"tokens": torch.from_numpy(toks)},
                   max_new_tokens=n_new, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, n_new)
    # the reference's logits at each step, for the margin rule
    logits, cache = JM.prefill(J_CFG, jr, params,
                               {"tokens": jnp.asarray(toks)})
    for i in range(n_new):
        top2 = np.sort(_np(logits)[:, 0, :V], axis=-1)[:, -2:]
        margin = (top2[:, 1] - top2[:, 0]).min()
        if margin <= LOGIT_TOL["float32"] * np.abs(top2).max():
            break
        np.testing.assert_array_equal(got[:, i].numpy(), want[:, i])
        logits, cache = JM.decode_step(J_CFG, jr, params, cache,
                                       jnp.asarray(want[:, i:i + 1]),
                                       jnp.int32(40 + i))
    assert i > 0, "the first step was already a near-tie"


def test_temperature_sampling_is_seeded(lm):
    _, model = lm
    _, tr = _rcfgs("float32", True, 12)
    batch = {"tokens": torch.from_numpy(_prompt(8, seed=4))}
    runs = [generate(CFG, tr, model, batch, max_new_tokens=4,
                     temperature=1.0, seed=seed, device="cpu")
            for seed in (5, 5)]
    assert torch.equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < V)).all()
