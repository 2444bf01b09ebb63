"""The port's dry run (``launch/dryrun.py``) and roofline
(``launch/roofline.py``) on the CPU, at smoke width.

* One cell of each kind (train, prefill, decode) for a dense, an MoE, a
  Mamba2 and the enc-dec arch, on a ``fake`` 2 x 2 group: ``op_cost``,
  taken on fake tensors, equals ``cost_of`` of the same function on real
  tensors of the same shapes, exactly; the state bytes per device equal
  the local shard sizes the rules give each leaf (numel over the mesh
  axes its spec names); the per-kind collective counts equal
  ``CommDebugMode``'s, and nothing was allocated at full size.
* ``roofline.terms`` on a record of the 16 x 16 and of the 2 x 16 x 16
  mesh equals the reference's ``terms`` (pure Python) on the same record,
  each time term scaled by the ratio of the two packages' constants.
* A failing cell writes its ``.err`` file and the CLI exits 1; a skipped
  cell writes its reason; the roofline CLI prints a row per record.

Every ``fake`` group is started and destroyed inside ``build_cell``.
"""
import json

import pytest
import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig, smoke_model
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.models import model as M
from repro_torch.runtime import sharding as shd
from repro_torch.train.optimizer import make_optimizer

MESH = ((2, 2), ("data", "model"))
SHAPES = {"train": ShapeConfig("t", 32, 8, "train"),
          "prefill": ShapeConfig("p", 32, 8, "prefill"),
          "decode": ShapeConfig("d", 32, 8, "decode")}
ARCH_CASES = ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
              "whisper-small"]


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


def _local_bytes(tree, rules, sizes) -> int:
    """Bytes of one rank's shards: each leaf's numel over the product of
    the mesh axes its spec names."""
    total = 0
    for path, x in shd.tree_items(tree):
        spec = rules.spec_for(shd.resolve_axes(path, x.dim()), x.shape,
                              FakeMesh(sizes))
        div = 1
        for entry in spec:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                div *= sizes[ax] if ax else 1
        total += x.numel() // div * x.element_size()
    return total


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_CASES)
def test_cell_prices_fake_as_real(arch, kind):
    cfg = smoke_model(ARCHS[arch])
    shape = SHAPES[kind]
    rec = D.build_cell(arch, kind, False, cfg=cfg, shape=shape, mesh=MESH)
    rcfg = D.run_config(cfg, shape, False, {})
    real = D.cell_cost(cfg, rcfg, shape, torch.float32)    # real zeros
    op = rec["op_cost"]
    assert (op["flops"], op["dot_flops"], op["bytes_unfused"]) == \
        (real.flops, real.dot_flops, real.bytes)
    assert op["dot_flops"] > 0

    sizes = dict(zip(*reversed(MESH)))
    params = M.param_specs(cfg)
    want = _local_bytes(params, D.RULES, sizes)
    if kind == "train":
        want += _local_bytes(make_optimizer(rcfg).init(params), D.RULES,
                             sizes)
    elif kind == "decode":
        want += _local_bytes(M.cache_specs(cfg, rcfg, shape), D.RULES, sizes)
    assert rec["state_bytes_per_device"] == want

    coll = rec["collectives"]
    counts = coll["comm_debug_counts"]
    for kind_, packet in (("all-gather", "all_gather_into_tensor"),
                          ("all-reduce", "all_reduce"),
                          ("reduce-scatter", "reduce_scatter_tensor")):
        assert coll["per_op"][kind_]["count"] == counts.get(
            f"c10d_functional.{packet}", 0)
    assert coll["per_op"]["all-gather"]["count"] > 0   # weights gathered
    assert coll["totals"]["count"] == sum(counts.values())
    assert rec["memory"] is None and rec["memory_note"]
    assert rec["mesh_shape"] == {"data": 2, "model": 2}
    assert rec["n_devices"] == 4


@pytest.mark.parametrize("multi_pod,kind", [(False, "train"),
                                            (True, "decode")])
def test_roofline_terms_are_the_reference_scaled(multi_pod, kind):
    from repro.launch import roofline as JR
    cfg = smoke_model(ARCHS["qwen2-1.5b"])
    n_data = 32 if multi_pod else 16
    shape = ShapeConfig(kind, 32, n_data, kind)
    label = {"train": "train_4k", "decode": "decode_32k"}[kind]
    rec = D.build_cell("qwen2-1.5b", label, multi_pod, cfg=cfg, shape=shape)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    got = R.terms(rec)
    ref = JR.terms(dict(rec, jaxpr_cost=rec["op_cost"]))
    flops, hbm = JR.PEAK_FLOPS / R.PEAK_FLOPS, JR.HBM_BW / R.HBM_BW
    for key, ratio in (("t_compute", flops), ("t_mem_lo", hbm),
                       ("t_mem_hi", hbm), ("t_mem", hbm),
                       ("t_coll", JR.LINK_BW / R.LINK_BW)):
        assert got[key] == pytest.approx(ref[key] * ratio, rel=1e-12), key
    assert got["useful_ratio"] == ref["useful_ratio"]
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 50e9)


def test_failing_cell_writes_err_and_exits_1(tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("a host read on a fake tensor")
    monkeypatch.setattr(D, "build_cell", boom)
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                "--out", str(tmp_path)])
    assert e.value.code == 1
    err = (tmp_path / "qwen2-1.5b__train_4k__16x16.err").read_text()
    assert "a host read on a fake tensor" in err
    with pytest.raises(SystemExit) as e:       # a skipped cell is no failure
        D.main(["--arch", "qwen2-1.5b", "--shape", "long_500k",
                "--out", str(tmp_path)])
    assert e.value.code == 0
    skipped = json.loads(
        (tmp_path / "qwen2-1.5b__long_500k__16x16.json").read_text())
    assert "skipped" in skipped


def test_roofline_cli_prints_each_record(tmp_path, capsys):
    cfg = smoke_model(ARCHS["phi3.5-moe-42b-a6.6b"])
    rec = D.build_cell("phi3.5-moe-42b-a6.6b", "prefill_32k", False,
                       cfg=cfg, shape=ShapeConfig("p", 32, 16, "prefill"))
    rec["tag"] = ""
    (tmp_path / "phi__prefill__16x16.json").write_text(json.dumps(rec))
    capsys.readouterr()
    R.main(["--dir", str(tmp_path), "--md", str(tmp_path / "r.md")])
    out = capsys.readouterr().out
    assert "| phi3.5-moe-42b-a6.6b | prefill_32k | 16x16 |" in out
    assert (tmp_path / "r.md").read_text().strip() == out.strip()


def test_run_config_follows_the_reference_choices():
    rcfg = D.run_config(ARCHS["deepseek-67b"], D.SHAPES["train_4k"], False,
                        {}, "deepseek-67b", "train_4k")
    assert isinstance(rcfg, RunConfig)
    assert (rcfg.optimizer, rcfg.microbatches, rcfg.remat) == \
        ("adamw", 4, "full")
    big = D.run_config(ARCHS["jamba-1.5-large-398b"], D.SHAPES["decode_32k"],
                       True, {"serve_tp": True}, "jamba-1.5-large-398b",
                       "decode_32k")
    assert (big.optimizer, big.microbatches, big.remat, big.serve_tp) == \
        ("adafactor", 1, "none", True)


@pytest.mark.parametrize("arch,kind", [("qwen2-1.5b", "train"),
                                       ("jamba-1.5-large-398b", "prefill"),
                                       ("whisper-small", "decode")])
def test_depth_extrapolation_is_exact(arch, kind):
    """A model of 3 blocks priced at 1 and 2 blocks and extrapolated
    equals the same model priced whole, count for count; and its op cost
    equals ``cost_of`` on real tensors of the whole model."""
    import dataclasses
    cfg = smoke_model(ARCHS[arch])
    cut = {"num_layers": 3 * len(cfg.full_pattern)}
    if cfg.encoder_layers:
        cut["encoder_layers"] = 3 * cfg.encoder_layers
    cfg = dataclasses.replace(cfg, **cut)
    shape = SHAPES[kind]
    got = D.build_cell(arch, kind, False, cfg=cfg, shape=shape, mesh=MESH)
    whole = D.build_cell(arch, kind, False, cfg=cfg, shape=shape, mesh=MESH,
                         extrapolate=False)
    assert got["depth"] == {"blocks": 3, "priced_blocks": [1, 2]}
    assert whole["depth"] == {"blocks": 3, "priced_blocks": [3]}
    for key in ("op_cost", "state_bytes_per_device", "collectives"):
        assert got[key] == whole[key], key
    real = D.cell_cost(cfg, D.run_config(cfg, shape, False, {}), shape,
                       torch.float32)
    assert (got["op_cost"]["flops"], got["op_cost"]["bytes_unfused"]) == \
        (real.flops, real.bytes)


@pytest.mark.parametrize("arch,over,share", [
    ("qwen2-1.5b", {}, 4),                       # every model dim splits
    ("qwen2-1.5b", {"num_heads": 3, "num_kv_heads": 1}, None)])
def test_device_cost_is_rank_zeros_share(arch, over, share):
    """Rank 0's FLOPs of the tensor-parallel step on 2 x 2: a quarter of
    the global count where the rules split every model dim; more where
    the fallback replicates the heads, which the compute note names."""
    import dataclasses
    cfg = dataclasses.replace(smoke_model(ARCHS[arch]), **over)
    rec = D.build_cell(arch, "train_4k", False, cfg=cfg,
                       shape=SHAPES["train"], mesh=MESH)
    dev, glob = rec["device_cost"], rec["op_cost"]
    if share:
        assert dev["dot_flops"] * share == glob["dot_flops"]
        assert "no dim is replicated" in rec["compute_note"]
    else:
        assert glob["dot_flops"] / 4 < dev["dot_flops"] < glob["dot_flops"]
        assert "heads 3, kv_heads 1" in rec["compute_note"]
    t = R.terms(rec)
    assert t["t_compute_device"] == dev["flops"] / R.PEAK_FLOPS


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-780m"])
def test_seq_parallel_cuts_the_activation_all_reduces(arch):
    """``--seq-parallel`` on a 2 x 2 train cell: the sequence is gathered
    and reduce-scattered over ``"model"`` where the layers all-reduced
    their ``[tokens, d]`` activations, so fewer all-reduce wire bytes and
    more reduce-scatters; the compute note says so."""
    cfg = smoke_model(ARCHS[arch])
    tp = D.build_cell(arch, "train", False, cfg=cfg, shape=SHAPES["train"],
                      mesh=MESH)
    sp = D.build_cell(arch, "train", False, {"seq_parallel": True}, cfg=cfg,
                      shape=SHAPES["train"], mesh=MESH)
    wire = {k: (tp["collectives"]["per_op"][k], sp["collectives"]["per_op"][k])
            for k in ("all-reduce", "reduce-scatter")}
    a, b = wire["all-reduce"]
    assert b["wire_bytes"] < a["wire_bytes"] / 4, wire
    a, b = wire["reduce-scatter"]
    assert b["count"] > a["count"], wire
    assert sp["compute_note"].startswith("sequence-parallel")
    assert tp["compute_note"].startswith("tensor-parallel")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-small"])
def test_decode_cell_reads_the_cache_in_place(arch):
    """A decode cell on (data 1, model 2): each rank's cache is its half
    of every ring (``cache_seq``), read where it lies: no all-gather
    moves as many bytes as one layer's whole K leaf."""
    cfg = smoke_model(ARCHS[arch])
    shape = ShapeConfig("d", 64, 8, "decode")
    rec = D.build_cell(arch, "decode", False, cfg=cfg, shape=shape,
                       mesh=((1, 2), ("data", "model")))
    rcfg = D.run_config(cfg, shape, False, {})
    cache = M.cache_specs(cfg, rcfg, shape)
    k = (cache["k"] if isinstance(cache, dict) else cache[0]["k"])[0]
    whole_leaf = k.numel() * k.element_size()
    gathers = rec["collectives"]["per_op"]["all-gather"]
    assert 0 < gathers["result_bytes"] < whole_leaf, gathers
