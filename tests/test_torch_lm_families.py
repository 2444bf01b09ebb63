"""Every architecture of ``configs/archs.py`` at smoke width, the port's
serving path against the reference's, on the CPU.

Weights come from the reference's init (``repro.models.model.init``) and
are carried over by :func:`repro_torch.convert.to_lm_params` (whisper:
``to_encdec_params``); prompts, whisper's frames and pixtral's patch
embeddings are drawn with numpy from a seed.  The prompt (80 tokens, plus
pixtral's 8-patch prefix) passes the smoke ``attn_chunk`` of 64, so the
prefill takes the chunked attention path, and the 32-token window of
gemma2's local layers.  The port runs jamba's SSD chunk through the
kernel's wrapper (its plain version on the CPU) and every MoE's bucket
count through the bucket-count kernel's wrapper (likewise); the reference
runs its einsum and ``jnp`` paths.

Tolerances:

* logits, every position of the prefill and each of 4 decode steps
  (fed the reference's greedy tokens): f32 within 1e-4 of the largest
  reference logit; bf16 within 0.05 of it (the two frameworks round bf16
  products at other places);
* the prefill cache, f32: K/V and the conv state (stored in bf16 by both)
  within one bf16 ulp (rtol 2**-7) plus 1e-4 of the largest entry, ``pos``
  equal, SSM states within 1e-4 of the largest; bf16 within 0.05;
* bf16 with MoE layers: a token whose k-th and (k+1)-th router
  probabilities lie within 0.05 of each other in log space, in any MoE
  layer of the reference (its ``_route``, recorded through a host
  callback), may take the other expert in the port.  A prompt row's
  logits and K/V are compared at the positions before its first such
  near-tie, since a changed expert reaches every later position through
  attention; the SSM and conv states, which summarise a whole row, are
  compared for the rows without one.  The bf16 prefill runs 8 rows, and
  at least 16 positions in all must stay comparable; each arch's
  per-row cutoffs are printed;
* ``moe_dropped`` equal (0: inference is dropless), ``moe_aux`` within
  rtol 1e-5 (f32);
* greedy tokens of ``generate``, f32: equal at every step up to the first
  whose reference top-2 margin is within the logit tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as JA
from repro.configs import base as JB
from repro.configs.archs import ARCHS as J_ARCHS
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import smoke_model as j_smoke
from repro.models import model as JM
from repro.moe import moe_layer as j_moe_layer
from repro.serve.serve_step import pad_cache as j_pad_cache
from repro_torch.configs import archs as TA
from repro_torch.configs import base as TB
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
from repro_torch.convert import to_encdec_params, to_lm_params
from repro_torch.kernels.coalesce import bucket_count_kernel
from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
from repro_torch.models import model as M
from repro_torch.serve.serve_step import generate, pad_cache

S, B, NEW = 80, 2, 5
B_BF16 = 8          # rows of the bf16 prefill: a near-tie ends one row's check
TOL = {"float32": 1e-4, "bfloat16": 0.05}
TIE = 0.05
MIN_COMPARED = 16   # bf16 positions that must stay comparable, all rows


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


def _close_rel(got, want, tol, what, scale=None):
    """max |got - want| within ``tol`` of ``scale`` (default: the largest
    |want|)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max() if scale is None else scale
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: |diff| {err} > {tol} x {scale}"


@functools.lru_cache(maxsize=None)
def _models(name):
    jcfg, cfg = j_smoke(J_ARCHS[name]), smoke_model(ARCHS[name])
    params, _ = JM.init(jcfg, jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, params)
    convert = to_encdec_params if jcfg.encoder_layers else to_lm_params
    model = M.init(cfg, 1, device="cpu")
    model.load_state_dict(convert(cfg, host, device="cpu"))
    return jcfg, cfg, params, model


def _batch(cfg, seed=0, rows=B):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (rows, S))
             .astype(np.int32)}
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patch":
        batch["patch_embeds"] = rng.standard_normal(
            (rows, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return batch


def _rcfgs(jcfg, cfg, dtype, length, rows=B):
    return (JRunConfig(model=jcfg, shape=JShapeConfig("t", length, rows,
                                                      "decode"),
                       compute_dtype=dtype),
            RunConfig(model=cfg, shape=ShapeConfig("t", length, rows,
                                                   "decode"),
                      compute_dtype=dtype, use_pallas=True))


def _flat_cache(cache):
    """[(name, array)] of a cache in either layout (list of dicts or a
    dict)."""
    if isinstance(cache, dict):
        return sorted(cache.items())
    return [(f"{i}.{k}", v) for i, e in enumerate(cache)
            for k, v in sorted(e.items())]


def _record_reference_router(monkeypatch, sink):
    """Patch the reference's ``_route`` so that each MoE layer's router
    probabilities [T, E] reach ``sink`` (through a host callback: the
    layers run under ``lax.scan``)."""
    route = j_moe_layer._route

    def recording(cfg, p, x):
        out = route(cfg, p, x)
        jax.debug.callback(lambda a: sink.append(np.asarray(a)), out[2])
        return out
    monkeypatch.setattr(j_moe_layer, "_route", recording)


def _near_tie_cutoffs(probs, k: int, rows: int) -> np.ndarray:
    """Per row, the first position at which any MoE layer's k-th and
    (k+1)-th router probabilities lie within :data:`TIE` of each other in
    log space (the row's length if none does)."""
    seq = probs[0].shape[0] // rows
    cut = np.full(rows, seq)
    for p in probs:
        top = -np.sort(-p.astype(np.float64), axis=-1)
        near = (np.log(top[:, k - 1]) - np.log(top[:, k]) < TIE) \
            .reshape(rows, seq)
        cut = np.minimum(cut, np.where(near.any(1), near.argmax(1), seq))
    return cut


def _check_prefill(name, dtype, monkeypatch):
    jcfg, cfg, params, model = _models(name)
    rows = B if dtype == "float32" else B_BF16
    jr, tr = _rcfgs(jcfg, cfg, dtype, S + NEW, rows)
    batch = _batch(cfg, rows=rows)
    n_moe = sum(spec.mlp == "moe" for spec in cfg.full_pattern) \
        * cfg.num_blocks
    probs = []
    if dtype == "bfloat16" and n_moe:
        _record_reference_router(monkeypatch, probs)
    jl, jcache, jmet = JM._forward(
        jcfg, jr, params, {k: jnp.asarray(v) for k, v in batch.items()},
        "prefill")
    jax.effects_barrier()
    ssd_before, count_before = (ssd_chunk_kernel.launches,
                                bucket_count_kernel.launches)
    with torch.no_grad():
        tl, tcache, tmet = M._forward(
            cfg, tr, model, {k: torch.from_numpy(v) for k, v in batch.items()},
            "prefill")
    # the CPU runs the kernels' plain versions, never a kernel
    assert ssd_chunk_kernel.launches == ssd_before
    assert bucket_count_kernel.launches == count_before
    tol, v = TOL[dtype], cfg.vocab_size
    assert tl.dtype == getattr(torch, dtype)
    # in bf16 a routing near-tie may flip; compare each row before its own
    seq = tl.shape[1]
    cut = np.full(rows, seq)
    if probs:
        assert len(probs) == n_moe, (name, len(probs), n_moe)
        cut = _near_tie_cutoffs(probs, cfg.experts_per_token, rows)
        print(f"{name} bf16: positions compared per row {cut.tolist()} "
              f"of {seq}")
        assert cut.sum() >= MIN_COMPARED, (name, cut.tolist())
    whole = cut == seq
    np.testing.assert_array_equal(_np(tl)[..., v:], _np(jl)[..., v:])
    scale = np.abs(_np(jl)[..., :v]).max()
    for r in np.flatnonzero(cut):
        _close_rel(_np(tl)[r, :cut[r], :v], _np(jl)[r, :cut[r], :v], tol,
                   f"{name} logits row {r}", scale=scale)
    jflat, tflat = _flat_cache(jcache), _flat_cache(tcache)
    assert [k for k, _ in tflat] == [k for k, _ in jflat]
    for (key, t), (_, j) in zip(tflat, jflat):
        assert str(t.dtype)[6:] == str(j.dtype), key
        assert tuple(t.shape) == j.shape, key
        if key.endswith("pos"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        elif dtype == "float32" and t.dtype == torch.bfloat16:
            np.testing.assert_allclose(
                _np(t), _np(j), rtol=2 ** -7,
                atol=1e-4 * np.abs(_np(j)).max(), err_msg=f"{name} {key}")
        elif whole.all():
            _close_rel(t, j, tol, f"{name} cache {key}")
        elif key[-1] in "kv":      # [blocks, B, S, KV, D]
            for r in np.flatnonzero(cut):
                _close_rel(_np(t)[:, r, :cut[r]], _np(j)[:, r, :cut[r]], tol,
                           f"{name} cache {key} row {r}",
                           scale=np.abs(_np(j)).max())
        elif whole.any():          # a whole row's state: [blocks, B, ...]
            _close_rel(_np(t)[:, whole], _np(j)[:, whole], tol,
                       f"{name} cache {key}", scale=np.abs(_np(j)).max())
    assert int(tmet["moe_dropped"]) == int(jmet["moe_dropped"]) == 0
    assert tmet["moe_dropped"].dtype == torch.int32
    np.testing.assert_allclose(float(tmet["moe_aux"]), float(jmet["moe_aux"]),
                               rtol=1e-5 if dtype == "float32" else 0.05)
    return jl, tcache, jcache


@pytest.mark.parametrize("name", list(J_ARCHS))
def test_prefill_decode_generate_match_reference(name, monkeypatch):
    """f32: the prefill's logits, cache and metrics; 4 decode steps from
    the padded cache fed the reference's greedy tokens; greedy
    ``generate`` against the reference's greedy decode."""
    jcfg, cfg, params, model = _models(name)
    jl, tcache, jcache = _check_prefill(name, "float32", monkeypatch)
    monkeypatch.undo()
    jr, tr = _rcfgs(jcfg, cfg, "float32", S + NEW)
    batch = _batch(cfg)
    prompt = S + cfg.frontend_seq if cfg.frontend == "patch" else S
    # the reference's greedy decode (its ``generate``'s loop: prefill, pad
    # the cache to S + NEW, argmax, decode; jitted once here rather than
    # twice), the port's decode steps fed its tokens
    v = cfg.vocab_size
    jdec = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, jr, p, c, t,
                                                       pos))
    jc = j_pad_cache(jcfg, jcache, prompt + NEW)
    tc = pad_cache(cfg, tcache, prompt + NEW)
    jlogits, want, margins_ok = jl[:, -1:], [], []
    for i in range(NEW):
        top2 = np.sort(_np(jlogits)[:, 0, :v], axis=-1)[:, -2:]
        margins_ok.append((top2[:, 1] - top2[:, 0]).min()
                          > TOL["float32"] * np.abs(top2).max())
        want.append(np.argmax(_np(jlogits), axis=-1).astype(np.int32))
        if i == NEW - 1:
            break
        jlogits, jc = jdec(params, jc, jnp.asarray(want[-1]),
                           jnp.int32(prompt + i))
        tlogits, tc = M.decode_step(cfg, tr, model, tc,
                                    torch.from_numpy(want[-1]), prompt + i)
        _close_rel(_np(tlogits)[..., :v], _np(jlogits)[..., :v],
                   TOL["float32"], f"{name} decode step {i}")
    for (key, t), (_, j) in zip(_flat_cache(tc), _flat_cache(jc)):
        if key.endswith("pos"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    want = np.concatenate(want, axis=1)

    got = generate(cfg, tr, model, {k: torch.from_numpy(a)
                                    for k, a in batch.items()},
                   max_new_tokens=NEW, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    for i, ok in enumerate(margins_ok):
        if not ok:
            break
        np.testing.assert_array_equal(got[:, i].numpy(), want[:, i],
                                      err_msg=f"{name} token {i}")
    assert margins_ok[0], "the first step was already a near-tie"


@pytest.mark.parametrize("name", list(J_ARCHS))
def test_bf16_prefill_matches_reference(name, monkeypatch):
    _check_prefill(name, "bfloat16", monkeypatch)


def test_configs_match_reference():
    """Every arch, full and smoke: the fields, the analytic parameter
    counts; ``SHAPES``, ``LONG_CONTEXT_OK`` and ``skip_reason``."""
    assert list(ARCHS) == list(J_ARCHS)
    for name in ARCHS:
        for t, j in ((ARCHS[name], J_ARCHS[name]),
                     (smoke_model(ARCHS[name]), j_smoke(J_ARCHS[name]))):
            assert repr(t) == repr(j)
            assert t.param_count() == j.param_count()
            assert t.active_param_count() == j.active_param_count()
            assert t._attn_params() == j._attn_params()
        for shape in JB.SHAPES:
            assert TA.skip_reason(name, shape) == JA.skip_reason(name, shape)
    assert {k: repr(v) for k, v in TB.SHAPES.items()} == \
        {k: repr(v) for k, v in JB.SHAPES.items()}
    assert TA.LONG_CONTEXT_OK == JA.LONG_CONTEXT_OK
