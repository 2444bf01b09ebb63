"""The port's MoE layer (AAM dispatch through the coalescing planner, and
the GShard one-hot oracle) against the reference's, on the CPU.

Expert weights come from the reference's ``moe_init`` and load into the
port's ``MoE`` as they are; activations are drawn with numpy from a seed.
Tolerances, f32: outputs within atol 1e-5 times the largest reference
output (aam against dense in the port, and each against the reference's
aam; outputs reach about 200 with the reference's init, whose expert
weights scale by E ** -0.5, so an absolute 1e-5 would be below f32's
rounding of the sums), the routing (weights within 1e-6, experts equal)
and ``moe_dropped`` equal, ``moe_aux`` within rtol 1e-6.
Plans: every field equal, whichever histogram counts them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as J_ARCHS
from repro.configs.base import smoke_model as j_smoke
from repro.moe import moe_layer as jm
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import smoke_model
from repro_torch.core.coalescing import plan_buckets_sorted
from repro_torch.moe import moe_layer as tm

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each
    (a worker's default of one thread per core makes the port's small
    ops several times slower under the suite's load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_smoke(J_ARCHS[arch]), **kw),
            dataclasses.replace(smoke_model(ARCHS[arch]), **kw))


def _layer(arch, seed=0, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    jp, _ = jm.moe_init(jcfg, jax.random.PRNGKey(seed))
    p = tm.MoE(cfg, torch.Generator().manual_seed(0))
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    return jcfg, cfg, jp, p.requires_grad_(False)


def _close(got, want, scale_of=None):
    want = np.asarray(want)
    scale = np.abs(np.asarray(want if scale_of is None else scale_of)).max()
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=ATOL * scale)


def _x(t, d, seed):
    return np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)


# qwen3-moe (128 experts top-8 at full width; 4 top-2 at smoke width),
# phi3.5 (16 top-2), jamba's non-gated variant, and 8 experts top-3
LAYERS = {"qwen3": ("qwen3-moe-235b-a22b", {}),
          "phi35": ("phi3.5-moe-42b-a6.6b", {}),
          "gelu": ("phi3.5-moe-42b-a6.6b", dict(mlp_gated=False)),
          "e8k3": ("qwen3-moe-235b-a22b", dict(num_experts=8,
                                               experts_per_token=3))}


@pytest.mark.parametrize("mode", ["prefill", "train"])
@pytest.mark.parametrize("case", list(LAYERS))
def test_aam_matches_dense_and_reference(case, mode):
    """Inference modes are dropless; ``"train"`` drops over-capacity
    assignments in arrival order on both paths."""
    arch, kw = LAYERS[case]
    if mode == "train":          # a capacity under the mean load: drops
        kw = dict(kw, capacity_factor=0.75)
    jcfg, cfg, jp, p = _layer(arch, **kw)
    x = _x(64, cfg.d_model, seed=len(case))
    jy, jmet = jm.moe_apply_aam(jcfg, jp, jnp.asarray(x), mode=mode)
    ya, ma = tm.moe_apply_aam(cfg, p, torch.from_numpy(x), mode=mode)
    yd, md = tm.moe_apply_dense(cfg, p, torch.from_numpy(x), mode=mode)
    _close(ya, yd, jy)
    _close(ya, jy)
    _close(yd, jy)
    assert int(ma["moe_dropped"]) == int(md["moe_dropped"]) == \
        int(jmet["moe_dropped"])
    assert ma["moe_dropped"].dtype == md["moe_dropped"].dtype == torch.int32
    if mode == "train":
        assert int(ma["moe_dropped"]) > 0
    else:
        assert int(ma["moe_dropped"]) == 0
    for m in (ma, md):
        np.testing.assert_allclose(float(m["moe_aux"]),
                                   float(jmet["moe_aux"]), rtol=1e-6)


def test_reference_dense_matches_port_dense():
    jcfg, cfg, jp, p = _layer("qwen3-moe-235b-a22b", seed=3)
    x = _x(40, cfg.d_model, seed=9)
    jy, jmet = jm.moe_apply_dense(jcfg, jp, jnp.asarray(x), mode="train")
    ty, tmet = tm.moe_apply_dense(cfg, p, torch.from_numpy(x), mode="train")
    _close(ty, jy)
    assert int(tmet["moe_dropped"]) == int(jmet["moe_dropped"])


@pytest.mark.parametrize("t", [1, 4, 37, 1000])
@pytest.mark.parametrize("dropless", [False, True])
def test_capacity_matches_reference(t, dropless):
    for arch, kw in LAYERS.values():
        jcfg, cfg = _cfgs(arch, **kw)
        assert tm._capacity(cfg, t, dropless) == \
            jm._capacity(jcfg, t, dropless)


def test_route_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: the top k
    are the k lowest ids, as ``lax.top_k`` picks them."""
    jcfg, cfg, jp, p = _layer("qwen3-moe-235b-a22b", num_experts=8,
                              experts_per_token=3)
    with torch.no_grad():
        p.router.zero_()
        p.router[:, 5] = 1.0          # one clear winner, then a 7-way tie
    jp = dict(jp, router=jnp.asarray(p.router.numpy()))
    x = np.abs(_x(16, cfg.d_model, seed=4))
    jw, je, jprobs = jm._route(jcfg, jp, jnp.asarray(x))
    tw, te, tprobs = tm._route(cfg, p, torch.from_numpy(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert (te[:, 0] == 5).all() and (te[:, 1:] == torch.tensor([0, 1])).all()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=1e-6)


@pytest.mark.parametrize("case", ["qwen3", "phi35"])
def test_moe_apply_dispatch(case):
    """``impl`` selects the path; ``aam_shmap`` serves through aam outside
    ``"train"``, as the reference's does."""
    arch, kw = LAYERS[case]
    jcfg, cfg, jp, p = _layer(arch, **kw)
    x = torch.from_numpy(_x(24, cfg.d_model, seed=2))
    aam, _ = tm.moe_apply_aam(cfg, p, x, mode="decode")
    for impl in ("aam", "aam_shmap", "dense"):
        y, _ = tm.moe_apply(cfg, p, x, impl=impl, mode="decode")
        _close(y, aam)
    jy, _ = jm.moe_apply(jcfg, jp, jnp.asarray(x.numpy()), impl="aam_shmap",
                         mode="decode")
    _close(aam, jy)


@pytest.mark.parametrize("buckets,k", [(16, 2), (128, 8), (4, 2)])
def test_kernel_route_plan_equals_bincount_plan(buckets, k):
    """MoE owner ids (N = T x k, each token's k distinct experts):
    the plan through the bucket-count kernel's wrapper (its plain version
    on the CPU) equals the plan through ``torch.bincount``."""
    rng = np.random.default_rng(buckets)
    t = 300
    owner = torch.from_numpy(np.stack([rng.choice(buckets, k, replace=False)
                                       for _ in range(t)]).reshape(-1)
                             .astype(np.int32))
    valid = torch.ones(t * k, dtype=torch.bool)
    for cap in (t * k, 8, 40):
        pk, ok = plan_buckets_sorted(owner, valid, buckets, cap,
                                     count_backend="pallas")
        pj, oj = plan_buckets_sorted(owner, valid, buckets, cap,
                                     count_backend="jnp")
        for field in ("owner", "position", "counts", "kept", "dropped"):
            assert torch.equal(getattr(pk, field), getattr(pj, field)), field
        assert torch.equal(ok, oj)
        assert torch.equal(pk.counts, torch.bincount(owner,
                                                     minlength=buckets)
                           .to(torch.int32))
