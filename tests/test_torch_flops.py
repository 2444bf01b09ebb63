"""The port's FLOP and byte counter (``repro_torch.runtime.flops``)
against the reference's jaxpr walker (``repro.runtime.flops``), on the
CPU.

The port's parameters come from the reference's init through
:func:`repro_torch.convert.to_lm_params`.  ``dot_flops`` of the
``smoke_model`` prefills (2 x 16 tokens, f32) of qwen2-1.5b (dense),
phi3.5-moe (MoE), mamba2-780m (the plain SSD path) and jamba-1.5-large
(hybrid), and of one smoke loss-and-gradient step of qwen2-1.5b, equals
the reference's within rtol 1e-3.  One difference is the reference's
own: ``jnp.einsum`` runs the element-wise pair of a three-operand
einsum (the SSD chunk states and inter-chunk outputs) as a
``dot_general`` with no contracting dimension, which its walker counts
as dot FLOPs, where ``torch.einsum`` runs a ``mul``.  Those
contraction-free dots are found in the reference's jaxpr with its own
helpers and taken out of its total before the comparison; they are 0 for
qwen2 and phi3.5.  The reference's walker raises on none of these cases
here.  Total FLOPs and bytes are printed beside the reference's, not
gated (the two count softmax, casts and views differently).

A hand-built function covers every cost class with exact counts, and the
SSD kernel op's cost rule counts the dot FLOPs its plain version's two
batched products do.
"""
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
from repro.runtime import flops as JF
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
from repro_torch.convert import to_lm_params
from repro_torch.kernels.coarse_commit import coarse_commit_kernel
from repro_torch.kernels.ref import ssd_chunk_ref
from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
from repro_torch.models import model as M
from repro_torch.runtime.flops import cost_of

B, S = 2, 16
RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread
    each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(name):
    jcfg, cfg = j_smoke(J_ARCHS[name]), smoke_model(ARCHS[name])
    params, _ = JM.init(jcfg, jax.random.PRNGKey(0))
    model = M.init(cfg, 1, device="cpu")
    model.load_state_dict(to_lm_params(
        cfg, jax.tree.map(np.asarray, params), device="cpu"))
    return jcfg, cfg, params, model


def _rcfgs(jcfg, cfg, mode):
    return (JRunConfig(model=jcfg, shape=JShapeConfig("t", S, B, mode),
                       compute_dtype="float32"),
            RunConfig(model=cfg, shape=ShapeConfig("t", S, B, mode),
                      compute_dtype="float32"))


def _contraction_free_dots(fn, *args) -> float:
    """Dot FLOPs the reference's walker counts on ``dot_general``s with
    no contracting dimension (element-wise pairs of ``jnp.einsum``), with
    its own loop multipliers."""
    total = 0.0

    def walk(jaxpr, mult):
        nonlocal total
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general" \
                    and not eqn.params["dimension_numbers"][0][0]:
                total += JF._dot_flops(eqn) * mult
            for sub in JF._subjaxprs(eqn):
                walk(sub, mult * JF._multiplier(eqn))

    walk(jax.make_jaxpr(fn)(*args).jaxpr, 1.0)
    return total


def _compare(what, ref_fn, ref_args, port_fn):
    ref = JF.cost_of(ref_fn, *ref_args)
    free = _contraction_free_dots(ref_fn, *ref_args)
    got = cost_of(port_fn)
    print(f"{what}: dot FLOPs port {got.dot_flops:.0f}, reference "
          f"{ref.dot_flops:.0f} ({free:.0f} of them contraction-free); "
          f"FLOPs {got.flops:.0f} / {ref.flops:.0f}; bytes {got.bytes:.0f} "
          f"/ {ref.bytes:.0f}")
    np.testing.assert_allclose(got.dot_flops, ref.dot_flops - free,
                               rtol=RTOL)
    return got, free


@pytest.mark.parametrize("name,free", [
    ("qwen2-1.5b", False), ("phi3.5-moe-42b-a6.6b", False),
    ("mamba2-780m", True), ("jamba-1.5-large-398b", True)])
def test_prefill_dot_flops_match_reference(name, free):
    jcfg, cfg, params, model = _models(name)
    jr, tr = _rcfgs(jcfg, cfg, "prefill")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)

    def port():
        with torch.no_grad():
            return M._forward(cfg, tr, model,
                              {"tokens": torch.from_numpy(toks)}, "prefill")

    got, n_free = _compare(
        name, lambda p, b: JM._forward(jcfg, jr, p, b, "prefill"),
        (params, {"tokens": jnp.asarray(toks)}), port)
    assert (n_free > 0) == free
    n_moe = sum(spec.mlp == "moe" for spec in cfg.full_pattern) \
        * cfg.num_blocks
    # the bucket count is one op per MoE layer (its plain version here)
    assert got.calls.get("repro_torch::bucket_count", 0) == n_moe


def test_grad_step_dot_flops_match_reference():
    name = "qwen2-1.5b"
    jcfg, cfg, params, model = _models(name)
    jr, tr = _rcfgs(jcfg, cfg, "train")
    rng = np.random.default_rng(1)
    toks, labels = (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
                    for _ in range(2))

    def port():
        model.zero_grad(set_to_none=True)
        loss, _ = M.loss_fn(cfg, tr, model,
                            {"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(labels)})
        loss.backward()
        return loss

    _, n_free = _compare(
        f"{name} loss and gradients",
        jax.value_and_grad(lambda p, b: JM.loss_fn(jcfg, jr, p, b)[0]),
        (params, {"tokens": jnp.asarray(toks),
                  "labels": jnp.asarray(labels)}), port)
    assert n_free == 0


@pytest.mark.parametrize("b,s,remat", [(2, 16, "full"), (1, 256, "none")],
                         ids=["one_chunk", "two_chunks"])
def test_mamba2_step_dot_flops_pinned_to_reference(b, s, remat):
    """The smoke Mamba2 loss-and-gradient step's dot FLOPs against the
    reference's, each difference named.  With U = 2·b·nc·h·L²·N (one
    product of the chunked SSD) and V = 2·b·nc·L·h·N:

    * 2V at any length: the backward of the three-operand einsums (chunk
      states, inter-chunk output) towards their element-wise operand is a
      contracting ``dot_general`` in JAX and a mul and a sum in torch;
    * 3U more at one chunk (S <= 128): the chunk states and the
      inter-chunk term's state operand do not reach the loss there (the
      initial state is zero, the final one only fills the cache), so
      autograd skips their three backward products, where the reference's
      scan transposes zero cotangents."""
    name = "mamba2-780m"
    jcfg, cfg, params, model = _models(name)
    jr = JRunConfig(model=jcfg, shape=JShapeConfig("t", s, b, "train"),
                    compute_dtype="float32", remat=remat)
    tr = RunConfig(model=cfg, shape=ShapeConfig("t", s, b, "train"),
                   compute_dtype="float32", remat=remat)
    rng = np.random.default_rng(1)
    toks, labels = (rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
                    for _ in range(2))

    def port():
        model.zero_grad(set_to_none=True)
        loss, _ = M.loss_fn(cfg, tr, model,
                            {"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(labels)})
        loss.backward()
        return loss

    fn = jax.value_and_grad(lambda p, bt: JM.loss_fn(jcfg, jr, p, bt)[0])
    args = (params, {"tokens": jnp.asarray(toks),
                     "labels": jnp.asarray(labels)})
    ref = JF.cost_of(fn, *args).dot_flops - _contraction_free_dots(fn, *args)
    L = min(128, s)
    nc, h, n = s // L, cfg.ssm_heads, cfg.ssm_state
    U = 2 * b * nc * h * L * L * n
    V = 2 * b * nc * L * h * n
    gap = 2 * V + (3 * U if nc == 1 else 0)
    got = cost_of(port).dot_flops
    print(f"{name} {b} x {s} step: port {got:.0f}, reference {ref:.0f}, "
          f"gap {ref - got:.0f} = {'3U + ' if nc == 1 else ''}2V")
    assert got == ref - cfg.num_layers * gap


def test_every_cost_class_counts_exactly():
    a = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    b = torch.ones(8, 3)
    idx = torch.tensor([0, 3, 1, 1, 2])

    def f(a, b, idx):
        m = a @ b                    # mm: 2 * 4 * 3 * 8 = 192
        r = torch.exp(m).sum()       # pointwise 12, reduction 12
        return r, a[idx].reshape(40)  # gather: 160 output bytes; a view

    c = cost_of(f, a, b, idx)
    assert c.dot_flops == 192
    assert c.flops == 192 + 12 + 12 + 160
    # mm 128 + 96 + 48, exp 48 + 48, sum 48 + 4, index 128 + 40 + 160,
    # view 160 (output bytes only)
    assert c.bytes == 272 + 96 + 52 + 328 + 160
    assert dict(c.calls) == {"aten::mm": 1, "aten::exp": 1, "aten::sum": 1,
                             "aten::index": 1, "aten::view": 1}
    assert dict(c.by_prim) == {"aten::mm": 192, "aten::exp": 12,
                               "aten::sum": 12, "aten::index": 160}


def test_kernel_op_cost_rules():
    g = torch.Generator().manual_seed(0)
    C, Bm = torch.randn(6, 16, 8, generator=g), torch.randn(6, 16, 8,
                                                            generator=g)
    x, a = torch.randn(6, 16, 4, generator=g), -torch.rand(6, 16, generator=g)
    kernel = cost_of(ssd_chunk_kernel, C, Bm, x, a)
    plain = cost_of(ssd_chunk_ref, C, Bm, x, a)
    assert kernel.calls == {"repro_torch::ssd_chunk": 1}
    assert kernel.dot_flops == plain.dot_flops == 2 * 6 * 16 * 16 * (8 + 4)
    state = torch.zeros(100, dtype=torch.int32)
    idx = torch.randint(-1, 100, (50,), dtype=torch.int32, generator=g)
    c = cost_of(coarse_commit_kernel, state, idx, idx, op="max")
    assert (c.flops, c.dot_flops, c.bytes) == (50, 0, 800 + 200 + 200)
