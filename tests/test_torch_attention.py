"""The port's attention and layer helpers against the reference's, and its
two attention paths against each other, on the CPU.

Inputs are drawn with numpy from a seed; attention weights come from the
reference's ``attn_init`` and load into the port's ``Attention`` as they
are.  Tolerances, f32: outputs within 1e-5 of the largest reference
output (the two frameworks sum the same products in other orders); the
port's direct and chunked paths within 1e-5 of each other.  bf16: the
embedding scale bit for bit (both round the same value once); RoPE of
bf16 inputs within one bf16 ulp (2**-7 of the largest output).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as J_ARCHS
from repro.configs.base import smoke_model as j_smoke
from repro.models import attention as ja
from repro.models import layers as jl
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import smoke_model
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl

TOL = 1e-5


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


def _close(got, want, tol=TOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"{what}: {err}"


def _cfgs(arch="qwen2-1.5b", **kw):
    return (dataclasses.replace(j_smoke(J_ARCHS[arch]), **kw),
            dataclasses.replace(smoke_model(ARCHS[arch]), **kw))


def _params(jcfg, cfg, seed=0):
    jp, _ = ja.attn_init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    # non-zero biases and norm weights, so that both are exercised
    jp = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
              if k.startswith("b") or k.endswith("norm") else v)
          for k, v in jp.items()}
    p = ta.Attention(cfg, torch.Generator().manual_seed(0))
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    return jp, p


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _qkv(b, sq, sk, h, d, seed):
    return _x((b, sq, h, d), seed), _x((b, sk, h, d), seed + 1), \
        _x((b, sk, h, d), seed + 2)


def _pos(b, s, offset=0):
    return np.broadcast_to(np.arange(s, dtype=np.int32) + offset,
                           (b, s)).copy()


# --------------------------------------------------------------------------
# attention_core: direct and chunked, against the reference and each other
# --------------------------------------------------------------------------

CORE = [dict(), dict(window=24), dict(softcap_val=50.0),
        dict(window=24, softcap_val=30.0), dict(causal=False),
        dict(causal_skip=True), dict(kv_chunk_only=True)]


@pytest.mark.parametrize("kw", CORE, ids=lambda kw: ",".join(kw) or "causal")
def test_core_paths_match_reference_and_each_other(kw):
    q, k, v = _qkv(2, 96, 96, 4, 16, seed=len(kw))
    qp = kp = _pos(2, 96)
    want = ja.attention_core(*map(jnp.asarray, (q, k, v, qp, kp)),
                             chunk=32, **kw)
    tq, tk, tv, tqp, tkp = map(torch.from_numpy, (q, k, v, qp, kp))
    chunked = ta.attention_core(tq, tk, tv, tqp, tkp, chunk=32, **kw)
    direct = ta.attention_core(tq, tk, tv, tqp, tkp, force_direct=True,
                               **{k_: v_ for k_, v_ in kw.items()
                                  if k_ not in ("causal_skip",
                                                "kv_chunk_only")})
    _close(chunked, want, what="chunked vs reference")
    _close(direct, want, what="direct vs reference")
    _close(chunked, direct, what="chunked vs direct")


@pytest.mark.parametrize("sq,sk", [(1, 40), (12, 40), (40, 12)])
def test_core_with_empty_ring_slots(sq, sk):
    """Key slots with pos < 0 are masked; a query row that sees no valid
    key gives zeros, not NaN, on both paths."""
    q, k, v = _qkv(2, sq, sk, 4, 16, seed=sq)
    qp = _pos(2, sq, offset=3)
    kp = _pos(2, sk)
    kp[:, ::3] = -1
    kp[1] = -1                                    # row 1: nothing valid
    for kw in (dict(force_direct=True), dict(chunk=4)):
        want = ja.attention_core(*map(jnp.asarray, (q, k, v, qp, kp)), **kw)
        got = ta.attention_core(*map(torch.from_numpy, (q, k, v, qp, kp)),
                                **kw)
        assert torch.isfinite(got).all()
        _close(got, want, what=str(kw))


def test_largest_divisor_matches_reference():
    for n in (1, 7, 64, 96, 100, 131, 8192):
        for cap in (1, 5, 32, 1024, 4096):
            assert ta._largest_divisor_leq(n, cap) == \
                ja._largest_divisor_leq(n, cap)


# --------------------------------------------------------------------------
# projections, the layer, ring decode, cross attention
# --------------------------------------------------------------------------

LAYER = {"gqa_bias": ("qwen2-1.5b", {}),
         "mqa": ("granite-34b", {}),
         "mha_learned": ("whisper-small", {}),
         "qk_norm": ("qwen3-moe-235b-a22b", {}),
         "softcap_window": ("gemma2-27b", {}),
         "gqa_chunk": ("deepseek-67b", dict(attn_chunk=16))}
WINDOWS = {"softcap_window": 20, "mqa": 20}


@pytest.mark.parametrize("case", list(LAYER))
def test_attn_apply_matches_reference(case):
    arch, kw = LAYER[case]
    window = WINDOWS.get(case)
    jcfg, cfg = _cfgs(arch, **kw)
    jp, p = _params(jcfg, cfg)
    x, pos = _x((2, 48, cfg.d_model), seed=7), _pos(2, 48)
    jcall = ja.AttnCall(window=window,
                        use_rope=cfg.pos_embedding == "rope")
    tcall = ta.AttnCall(window=window,
                        use_rope=cfg.pos_embedding == "rope")
    jy, (jk, jv) = ja.attn_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                 jcall, chunk=16)
    ty, (tk, tv) = ta.attn_apply(cfg, p, torch.from_numpy(x),
                                 torch.from_numpy(pos), tcall, chunk=16)
    _close(ty, jy, what="out")
    _close(tk, jk, what="k")
    _close(tv, jv, what="v")
    # and the port's direct path on the same layer
    dy, _ = ta.attn_apply(cfg, p, torch.from_numpy(x), torch.from_numpy(pos),
                          tcall, chunk=48)
    _close(dy, ty, what="direct vs chunked")


@pytest.mark.parametrize("case", ["gqa_bias", "mqa", "softcap_window"])
def test_ring_decode_matches_reference(case):
    """A window-16 ring after 40 positions: slot = pos % 16, positions 24-39
    in it; 6 decode steps wrap it further."""
    arch, kw = LAYER[case]
    jcfg, cfg = _cfgs(arch, **kw)
    jp, p = _params(jcfg, cfg, seed=2)
    w, b = 16, 2
    rng = np.random.default_rng(3)
    kv_shape = (b, w, cfg.num_kv_heads, cfg.head_dim)
    ck = rng.normal(size=kv_shape).astype(np.float32)
    cv = rng.normal(size=kv_shape).astype(np.float32)
    cp = np.array([next(t for t in range(40 - w, 40) if t % w == s)
                   for s in range(w)], np.int32)
    jc = tuple(map(jnp.asarray, (ck, cv, cp)))
    tc = tuple(map(torch.from_numpy, (ck, cv, cp)))
    for i in range(6):
        x = _x((b, 1, cfg.d_model), seed=10 + i)
        jy, *jc = ja.attn_decode(jcfg, jp, jnp.asarray(x), 40 + i, *jc,
                                 ja.AttnCall(window=w))
        given, before = tc, [t.clone() for t in tc]
        ty, *tc = ta.attn_decode(cfg, p, torch.from_numpy(x), 40 + i, *tc,
                                 ta.AttnCall(window=w))
        # the caches passed in are left as they were
        assert all(torch.equal(a, b_) for a, b_ in zip(given, before))
        _close(ty, jy, what=f"step {i}")
        np.testing.assert_array_equal(tc[2].numpy(), np.asarray(jc[2]))
        _close(tc[0], jc[0], what="cache k")
    assert sorted(tc[2].tolist()) == list(range(46 - w, 46))


def test_cross_attention_matches_reference():
    jcfg, cfg = _cfgs("whisper-small")
    jp, p = _params(jcfg, cfg, seed=4)
    enc = _x((2, 24, cfg.d_model), seed=5)
    for sq in (1, 9):
        x = _x((2, sq, cfg.d_model), seed=sq)
        jk, jv = ja.project_kv(jcfg, jp, jnp.asarray(enc),
                               jnp.zeros((2, 24), jnp.int32), use_rope=False)
        tk, tv = ta.project_kv(cfg, p, torch.from_numpy(enc), None,
                               use_rope=False)
        _close(tk, jk, what="cross k")
        jy = ja.cross_attn_apply(jcfg, jp, jnp.asarray(x), jk, jv)
        ty = ta.cross_attn_apply(cfg, p, torch.from_numpy(x), tk, tv)
        _close(ty, jy, what=f"cross sq={sq}")


def test_repeat_kv_is_interleaved():
    x = torch.arange(2 * 3 * 2 * 1, dtype=torch.float32).reshape(2, 3, 2, 1)
    got = ta.repeat_kv(x, 6)
    want = np.asarray(ja.repeat_kv(jnp.asarray(x.numpy()), 6))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got[:, :, :3], x[:, :, :1].expand(2, 3, 3, 1))


# --------------------------------------------------------------------------
# layer helpers: RoPE, norms, MLPs, the embedding scale, softcaps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    x = _x((2, 33, 4, 16), seed=1)
    pos = _pos(2, 33, offset=5000)
    want = jl.rope(jnp.asarray(x).astype(dtype), jnp.asarray(pos), 1e6)
    got = tl.rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                  torch.from_numpy(pos), 1e6)
    assert got.dtype == getattr(torch, dtype)
    # angles to 5000 rad: sin/cos of the two libraries part in the last
    # f32 bits, one bf16 ulp at most after rounding
    _close(got, want, tol=1e-5 if dtype == "float32" else 2 ** -7)


@pytest.mark.parametrize("zero_centered", [False, True])
def test_rmsnorm_matches_reference(zero_centered):
    x, w = _x((3, 5, 64), seed=2), _x((64,), seed=3)
    want = jl.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                      zero_centered=zero_centered)
    got = tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                     zero_centered=zero_centered)
    _close(got, want)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-34b"])
def test_mlp_matches_reference(arch):
    """Gated SwiGLU, and the non-gated MLP with the tanh GELU."""
    jcfg, cfg = _cfgs(arch)
    jp, _ = jl.mlp_init(jcfg, jax.random.PRNGKey(1))
    p = tl.MLP(cfg, torch.Generator().manual_seed(0))
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    x = _x((2, 7, cfg.d_model), seed=4) * 3
    _close(tl.mlp_apply(cfg, p, torch.from_numpy(x)),
           jl.mlp_apply(jcfg, jp, jnp.asarray(x)))


def test_gemma_embedding_scale_and_softcap_match_reference():
    """sqrt(4608) rounds to 68.0 in bf16 before it scales; the final-logit
    softcap runs before the vocab mask."""
    jcfg, cfg = _cfgs("gemma2-27b", d_model=4608)
    assert float(tl.scalar(4608 ** 0.5, torch.zeros(
        (), dtype=torch.bfloat16))) == 68.0
    jp, _ = jl.embed_init(jcfg, jax.random.PRNGKey(2))
    p = tl.Embedding(cfg, torch.Generator().manual_seed(0))
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 6))
    for dtype in ("float32", "bfloat16"):
        want = jl.embed_tokens(jcfg, jp, jnp.asarray(toks), jnp.dtype(dtype))
        got = tl.embed_tokens(cfg, p, torch.from_numpy(toks),
                              getattr(torch, dtype))
        np.testing.assert_array_equal(_np(got), _np(want))
    x = _x((2, 3, 4608), seed=6)
    want = jl.lm_logits(jcfg, jp, jnp.asarray(x))
    got = tl.lm_logits(cfg, p, torch.from_numpy(x))
    v = cfg.vocab_size
    np.testing.assert_array_equal(_np(got)[..., v:], _np(want)[..., v:])
    assert np.abs(_np(got)[..., :v]).max() <= cfg.logit_softcap
    _close(got[..., :v], np.asarray(want)[..., :v])
