"""The dry run's memory record (``runtime/memory.py``, ``launch/dryrun.py``)
on the CPU, at smoke width.

* :class:`LiveBytes` exact to the byte: a freed temporary, views and
  in-place ops, a backward, a ``checkpoint`` recomputation, a DTensor's
  local shard; on real CPU tensors and under ``FakeTensorMode`` alike.
* A cell counted on fake tensors equals the same cell on real CPU tensors
  (a ``(1, 1)`` group), the bucket-count and SSD ops included.
* Argument, output and alias bytes against the reference's
  ``jax.jit(...).lower(...).compile().memory_analysis()`` on one CPU
  device, with the reference dry run's donation (train ``(0, 1)``, decode
  ``(1,)``), for qwen2-1.5b, phi3.5-moe, mamba2-780m and whisper-small x
  train, prefill and decode: equal up to scalars (64 B) once XLA's output
  tuple table (8 B a leaf) is taken off, but for the two differences
  ROADMAP Queue 3 records (the port's decode returns a new cache where
  the reference donates it; XLA drops whisper's encoder weights from a
  decode, which does not read them).  Temp and peak are not held to
  XLA's, which fuses and reuses buffers; the card holds them to its
  allocator (``chip_smoke.py`` phase 18).
* The record counts the memory on the whole depth: at 4 blocks it equals
  a run of the whole model, for each kind; and the train step's peak is
  not affine in the depth, which is why.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.checkpoint import checkpoint

from repro.configs.archs import ARCHS as J_ARCHS
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import smoke_model as j_smoke
from repro.models import model as JM
from repro.train.optimizer import make_optimizer as j_optimizer
from repro.train.train_step import make_train_step as j_train_step
from repro_torch.analysis.optrace import OpRecorder
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import ShapeConfig, smoke_model
from repro_torch.launch import dryrun as D
from repro_torch.models import model as M
from repro_torch.runtime.memory import FIELDS, LiveBytes

ONE = ((1, 1), ("data", "model"))
KINDS = ("train", "prefill", "decode")
ARCH_CASES = ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
              "whisper-small"]
SCALARS = 64            # bytes of scalars one package returns as tensors
TUPLE_ENTRY = 8         # XLA's output tuple: a pointer a leaf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread
    each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape(kind, seq=32, batch=8):
    return ShapeConfig(kind, seq, batch, kind)


def _mode(fake):
    return FakeTensorMode() if fake else torch.enable_grad()


# -- the counter ------------------------------------------------------------

N = 1000                # elements of the vectors below: 4,000 B in f32


@pytest.mark.parametrize("fake", [False, True])
def test_freed_temporary(fake):
    with _mode(fake):
        x = torch.ones(64, 64)
        with LiveBytes().known(x) as m:
            a = x @ x
            b = a.relu()
            del a
            c = b @ b
            del b
            assert m.live == 64 * 64 * 4
            del c
    assert (m.peak, m.live) == (2 * 64 * 64 * 4, 0)


@pytest.mark.parametrize("fake", [False, True])
def test_views_and_in_place_ops_add_nothing(fake):
    with _mode(fake):
        x = torch.ones(N)
        with LiveBytes().known(x) as m:
            v = x.view(10, 100).t()[1:]
            x.add_(1)
            u = x.mul_(2)
            y = torch.ones(N)           # new: counted
            z = y.unsqueeze(0).expand(3, N)
            y.sub_(u[0])
    assert (m.peak, m.live) == (4 * N, 4 * N)
    del v, z


@pytest.mark.parametrize("fake", [False, True])
def test_backward_is_counted(fake):
    """``grad((x * w).sum(), w)``: the product (4N) and the loss (4 B);
    the product freed (its backward saves x and w); the seed of ones
    (4 B) and w's gradient (4N) beside the loss."""
    with _mode(fake):
        x, w = torch.ones(N), torch.ones(N, requires_grad=True)
        with LiveBytes().known((x, w)) as m:
            g, = torch.autograd.grad((x * w).sum(), w)
    assert (m.peak, m.live) == (4 * N + 8, 4 * N)
    del g


@pytest.mark.parametrize("fake", [False, True])
def test_checkpoint_recompute_is_counted(fake):
    """``checkpoint(exp(x * w))``: the forward keeps only y (4N).  The
    backward recomputes x * w and its exp beside y, the loss and the
    seed: 12N + 8.  Uncounted, the recomputation would leave 8N + 8."""
    with _mode(fake):
        x, w = torch.ones(N), torch.ones(N, requires_grad=True)
        with LiveBytes().known((x, w)) as m:
            y = checkpoint(lambda t: (t * w).exp(), x, use_reentrant=False)
            assert m.live == 4 * N
            g, = torch.autograd.grad(y.sum(), w)
            del y
    assert (m.peak, m.live) == (12 * N + 8, 4 * N)
    del g


def test_dtensor_counts_its_local_shard():
    from torch.distributed.tensor import Shard, distribute_tensor
    with D.fake_mesh((4,), ("data",)) as dm, FakeTensorMode():
        x = distribute_tensor(torch.zeros(64, 16), dm, [Shard(0)])
        with LiveBytes().known(x) as m:
            y = x * 2                   # a DTensor of 16 x 16 local rows
            whole = y.full_tensor()     # gathered: 64 x 16
            assert m.live == (16 + 64) * 16 * 4
            del whole
    assert m.live == 16 * 16 * 4
    del y


# -- fake against real ------------------------------------------------------


@pytest.mark.parametrize("arch,kind,extra", [
    ("qwen2-1.5b", "train", {}), ("qwen2-1.5b", "prefill", {}),
    ("qwen2-1.5b", "decode", {}),
    ("phi3.5-moe-42b-a6.6b", "train", {}),            # the bucket count
    ("mamba2-780m", "prefill", {"use_pallas": True})])  # the SSD op
def test_fake_equals_real(arch, kind, extra):
    cfg = smoke_model(ARCHS[arch])
    shape = _shape(kind)
    rcfg = D.run_config(cfg, shape, False, extra)
    fake = D.cell_memory(cfg, rcfg, shape, *ONE, D.RULES, torch.float32)
    with D.fake_mesh(*ONE) as dm:
        call = D.cell_call(cfg, rcfg, shape, dm, D.RULES, torch.float32)
        with OpRecorder() as rec:
            _, real = D.counted_call(*call)
    names = {r.name for r in rec.records}
    assert ("repro_torch::bucket_count" in names) == ("moe" in arch)
    assert ("repro_torch::ssd_chunk" in names) == bool(extra)
    assert real == fake
    assert real["temp_size_in_bytes"] > 0


# -- the reference's memory_analysis ----------------------------------------


def _reference(arch, kind, shape):
    """The reference dry run's jit of the cell on one CPU device: its
    ``memory_analysis`` fields and the number of output leaves."""
    cfg = j_smoke(J_ARCHS[arch])
    jshape = JShapeConfig(kind, shape.seq_len, shape.global_batch, kind)
    rcfg = JRunConfig(model=cfg, shape=jshape, optimizer="adamw",
                      remat="full" if kind == "train" else "none",
                      microbatches=1, moe_impl="aam")
    params = JM.param_specs(cfg, jnp.float32)
    batch = JM.input_specs(cfg, jshape)
    if kind == "train":
        opt = j_optimizer(rcfg)
        fn = j_train_step(cfg, rcfg, opt)
        args = (params, jax.eval_shape(opt.init, params),
                jax.ShapeDtypeStruct((), jnp.int32), batch)
        donate = (0, 1)
    elif kind == "prefill":
        def fn(p, b):
            return JM.prefill(cfg, rcfg, p, b)
        args, donate = (params, batch), ()
    else:
        def fn(p, c, t, pos):
            return JM.decode_step(cfg, rcfg, p, c, t, pos)
        args = (params, JM.cache_specs(cfg, rcfg, jshape), batch["token"],
                batch["pos"])
        donate = (1,)
    mem = jax.jit(fn, donate_argnums=donate).lower(*args).compile() \
        .memory_analysis()
    leaves = len(jax.tree.leaves(jax.eval_shape(fn, *args)))
    return {f: int(getattr(mem, f)) for f in FIELDS}, leaves


def _bytes(tensors: dict) -> int:
    return sum(x.numel() * x.element_size() for x in tensors.values())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_CASES)
def test_arguments_outputs_aliases_match_the_reference(arch, kind):
    shape = _shape(kind)
    ref, leaves = _reference(arch, kind, shape)
    cfg = smoke_model(ARCHS[arch])
    rcfg = D.run_config(cfg, shape, False, {})
    got = D.cell_memory(cfg, rcfg, shape, *ONE, D.RULES, torch.float32)
    want = dict(ref, output_size_in_bytes=ref["output_size_in_bytes"]
                - TUPLE_ENTRY * leaves)
    if kind == "decode":
        cache = M.cache_specs(cfg, rcfg, shape)
        kept = {k: v for k, v in cache.items()
                if k in ("cross_k", "cross_v")} if M.is_encdec(cfg) else {}
        # the port's decode copies the cache and returns the copy; only
        # whisper's cross K/V pass through (ROADMAP Queue 3)
        want["alias_size_in_bytes"] = _bytes(kept)
        if M.is_encdec(cfg):
            # XLA drops the weights a decode does not read, the encoder's
            # and the cross K/V projections' (jit's keep_unused=False;
            # ROADMAP Queue 3); the port holds them
            unread = {k: v for k, v in M.param_specs(cfg).items()
                      if k.startswith(("encoder.", "enc_"))
                      or k.endswith(("cross.wk", "cross.wv"))}
            want["argument_size_in_bytes"] += _bytes(unread)
    for f in FIELDS[:3]:
        assert 0 <= want[f] - got[f] <= SCALARS, (f, got, want)
    if kind == "train":                 # parameters and AdamW in place
        assert got["alias_size_in_bytes"] == ref["alias_size_in_bytes"] > 0


# -- depth ------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_memory_is_counted_on_the_whole_depth(kind):
    """At 4 blocks the record's memory, the others priced at 1 and 2
    blocks, equals a run of the whole model; for the train step, a line
    through 1 and 2 blocks would miss it (the peak moves from the head's
    backward to the gradients as the layers add up)."""
    cfg = D._at_depth(smoke_model(ARCHS["qwen2-1.5b"]), 4)
    shape = _shape(kind)
    rec = D.build_cell("qwen2-1.5b", kind, False, cfg=cfg, shape=shape,
                       mesh=ONE)
    assert rec["depth"] == {"blocks": 4, "priced_blocks": [1, 2],
                            "memory_blocks": 4}
    rcfg = D.run_config(cfg, shape, False, {})
    cuts = [D._at_depth(cfg, b) for b in (1, 2, 4)]
    runs = [D.cell_memory(c, dataclasses.replace(rcfg, model=c), shape, *ONE,
                          D.RULES, torch.float32) for c in cuts]
    assert rec["memory"] == runs[2]
    line = D._affine(runs[0], runs[1], 4)
    for f in FIELDS[:3]:                # these are affine in depth
        assert line[f] == runs[2][f], f
    if kind == "train":
        assert line["peak_memory_in_bytes"] < runs[2]["peak_memory_in_bytes"]
