"""The sequence over ``"model"``: sequence parallelism in the sharded
train step and prefill (``runtime/sharding.py``'s ``gather_seq``,
``scatter_seq``, ``split_seq``; the layers of ``models/*.py`` and
``moe/moe_layer.py`` under ``rcfg.seq_parallel``) and decode over a cache
split on ``cache_seq`` (``attention.attn_decode``/``cross_attn_apply``,
``model.place_cache``), on gloo CPU ranks at smoke width, f32.

* **Parity with the unsharded step.** With ``seq_parallel=True`` on
  ``(1, 2)`` (the nine configs of ``test_torch_tp.py``, at a sequence of
  16 that 2 divides; pixtral's 8-patch prefix and whisper's 24 encoder
  frames divide too) and on ``(2, 2)`` (qwen2, phi3.5, mamba2): the loss,
  every leaf's gradient and one AdamW step against the unsharded step on
  the whole global batch, at ``test_torch_tp.py``'s bounds (whisper's
  bf16 bound; an MoE on ``(2, 2)`` held to the per-data-shard mean).
* **Fallback.** qwen2 and whisper at a sequence of 15, which 2 does not
  divide: the tensor-parallel program runs (no reduce-scatter over
  ``"model"``; whisper's encoder still splits its 24 frames) and matches.
* **Collectives.** qwen2's sequence-parallel forward on ``(1, 2)`` issues
  no all-reduce of a ``[B, S, d]`` activation; its all-gathers and
  reduce-scatters are, per layer, the weights read whole (q/k/v/o and
  the QKV biases), the grouped K/V, the MLP's input, and the MLP's
  output; once a forward, the lookup's reduce-scatter and the head's
  all-gather.
* **Decode.** ``generate`` on ``(1, 2)`` under ``SERVE_TP_RULES`` equals
  the unsharded ``generate`` token for token after a tensor-parallel and
  after a sequence-parallel prefill, for qwen2, phi3.5, mamba2, whisper,
  gemma2 at 3 heads with a ring window of 8 (shorter than the prompt),
  and qwen2 at W = 21 (odd: the kv heads take ``"model"``).  Each rank's
  ``k``/``v`` leaf holds W/2 slots (W where W is odd, then half the kv
  heads), and a decode step's collectives have no result with the slot
  dim.
* **Prefill.** The sequence-parallel prefill logits, gathered over the
  vocab, against the reference's ``_forward`` on the same weights, f32,
  at ``REF_ATOL``.
* **Module parity, no spawn.** The local-query attention core (one half
  of the positions against every key) against the reference's
  ``attention_core(kv_chunk_only=True)`` on the same rows; the two-part
  partial-softmax decode combine, one part all empty slots, against the
  reference's ``attn_decode`` on the whole cache.

Two spawned groups (``(1, 2)`` and ``(2, 2)``) serve every case; rank 0
writes the results, read here once a run and shared across xdist workers
(``_torch_once``).
"""
import contextlib
import dataclasses
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from _torch_once import once

import test_torch_tp as TP
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import TokenStream
from repro_torch.models import attention as ta
from repro_torch.models import model as M
from repro_torch.runtime import sharding as shd
from repro_torch.train import train_step as T
from repro_torch.train.optimizer import make_optimizer

SEQ, ODD_SEQ = 16, 15
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
CASES_2x2 = ("qwen2", "phi35_moe", "mamba2")
FALLBACK = ("qwen2", "whisper")
DECODE = {   # name -> (test_torch_tp case, overrides, new tokens)
    "qwen2": ("qwen2", {}, 4),
    "phi35_moe": ("phi35_moe", {}, 4),
    "mamba2": ("mamba2", {}, 4),
    "whisper": ("whisper", {}, 4),
    "gemma2_ring": ("gemma2_heads3", {"sliding_window": 8}, 4),
    "qwen2_odd": ("qwen2", {}, 5),
}
B, S = TP.B, TP.S           # serving: batch, prompt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread
    each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name, seq=SEQ):
    cfg, rcfg = TP._case(name)
    return cfg, dataclasses.replace(
        rcfg, seq_parallel=True, shape=ShapeConfig("t", seq, 4, "train"))


def _decode_case(name, seq_parallel=False):
    base, over, new = DECODE[name]
    cfg = dataclasses.replace(TP._case(base)[0], **over)
    return cfg, RunConfig(model=cfg, shape=ShapeConfig("s", S + new, B,
                                                       "decode"),
                          compute_dtype="float32", remat="none",
                          seq_parallel=seq_parallel), new


@contextlib.contextmanager
def _collectives():
    """``[(kind, result shape), ...]`` of every collective the sharding
    crossings issue while the context is open (the shapes they return:
    ``CommDebugMode`` sees an all-gather's result before it is laid out
    along its dim), then ``("total", n)``: ``CommDebugMode``'s count of
    every collective, which a test holds to the list's length."""
    from torch.distributed.tensor.debug import CommDebugMode
    kinds = {"_all_gather": "all-gather", "_reduce_scatter":
             "reduce-scatter", "_all_reduce": "all-reduce"}
    orig = {n: getattr(shd, n) for n in kinds}
    seen = []

    def wrap(name):
        def fn(*args):
            out = orig[name](*args)
            seen.append((kinds[name], tuple(out.shape)))
            return out
        return fn
    for n in kinds:
        setattr(shd, n, wrap(n))
    mode = CommDebugMode()
    try:
        with mode:
            yield seen
    finally:
        for n, f in orig.items():
            setattr(shd, n, f)
    seen.append(("total", mode.get_total_counts()))


def _train_rank(cfg, rcfg, mesh, out):
    _, params, opt_state = T.init_train_state(cfg, rcfg, device="cpu")
    sp = shd.shard_tree(params, TP.RULES, mesh)
    so = shd.shard_tree(opt_state, TP.RULES, mesh)
    batch = TokenStream(cfg, rcfg.shape, seed=0).batch(0)
    with _collectives() as log:
        grads, _, _ = T.make_sharded_grads(cfg, rcfg, mesh)(sp, batch)
    step = T.make_sharded_train_step(cfg, rcfg, make_optimizer(rcfg), mesh,
                                     TP.RULES)
    sp, so, metrics = step(sp, so, 0, batch)
    out.update(grads={k: g.full_tensor() for k, g in grads.items()},
               params={k: v.full_tensor() for k, v in sp.items()},
               loss=float(metrics["loss"]),
               scatters=sum(k == "reduce-scatter" for k, _ in log))


def _forward_collectives(mesh, out):
    """qwen2's sequence-parallel training forward: each collective's kind
    and result shape."""
    cfg, rcfg = _case("qwen2")
    _, params, _ = T.init_train_state(cfg, rcfg, device="cpu")
    model, slots = T.sharded_model(cfg, rcfg)
    shd.bind(slots, shd.shard_tree(params, TP.RULES, mesh))
    batch = TokenStream(cfg, rcfg.shape, seed=0).tensors(0, device="cpu")
    with _collectives() as log:
        M.loss_fn(cfg, rcfg, model, batch)
    out["forward"] = log


def _decode_rank(name, mesh, out):
    """``generate``'s tokens after a tensor-parallel and after a
    sequence-parallel prefill, the placed cache's leaf shapes, and one
    decode step's collectives."""
    from repro_torch.serve.serve_step import generate
    for sp in (False, True):
        cfg, rcfg, new = _decode_case(name, sp)
        params = shd.shard_tree(dict(M.init(cfg, 0, device="cpu")
                                     .named_parameters()), TP.SERVE, mesh)
        model, slots = T.sharded_model(cfg, rcfg)
        shd.bind(slots, params)
        batch = TP._serve_batch(cfg)
        out[f"tokens_{sp}"] = generate(cfg, rcfg, model, batch,
                                       max_new_tokens=new, device="cpu")
    _, cache = M.prefill(cfg, rcfg, model, batch, max_len=S + new)
    out["cache"] = {p: tuple(x.shape) for p, x in shd.tree_items(cache)}
    with _collectives() as log:
        M.decode_step(cfg, rcfg, model, cache, batch["tokens"][:, -1:], S)
    out["step"] = log


def _prefill_rank(name, mesh, weights, out):
    cfg, rcfg = TP._serve_case(name)
    rcfg = dataclasses.replace(rcfg, seq_parallel=True)
    params = shd.shard_tree(weights, TP.SERVE, mesh)
    model, slots = T.sharded_model(cfg, rcfg)
    shd.bind(slots, params)
    with torch.no_grad():
        logits, _, _ = M._forward(cfg, rcfg, model, TP._serve_batch(cfg),
                                  "prefill")
        out["logits"] = M.whole_logits(cfg, model, logits)


def _rank(rank, world, store_path, out_dir, dims):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)      # ranks share the host's cores
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(*dims, device="cpu")
        results = {}
        for name in (TP.CASES if dims == (1, 2) else CASES_2x2):
            results[name] = {}
            _train_rank(*_case(name), mesh, results[name])
        if dims == (1, 2):
            for name in FALLBACK:
                results[f"odd:{name}"] = {}
                _train_rank(*_case(name, ODD_SEQ), mesh,
                            results[f"odd:{name}"])
            _forward_collectives(mesh, results)
            for name in DECODE:
                results[f"decode:{name}"] = {}
                _decode_rank(name, mesh, results[f"decode:{name}"])
            weights = torch.load(f"{out_dir}/serve_weights.pt")
            for name in TP.SERVE_CASES:
                results[f"prefill:{name}"] = {}
                _prefill_rank(name, mesh, weights[name],
                              results[f"prefill:{name}"])
        if rank == 0:
            torch.save(results, f"{out_dir}/rank0.pt")
    finally:
        dist.destroy_process_group()


def _oracle(name, n_data, seq=SEQ):
    cfg, rcfg = _case(name, seq)
    model, params, _ = T.init_train_state(cfg, rcfg, device="cpu")
    batch = TokenStream(cfg, rcfg.shape, seed=0).tensors(0, device="cpu")
    if cfg.num_experts and n_data > 1:
        b = rcfg.shape.global_batch // n_data
        runs = [T.grads_fn(cfg, rcfg, model,
                           {k: v[j * b:(j + 1) * b] for k, v in batch.items()})
                for j in range(n_data)]
        grads = {k: sum(r[0][k] for r in runs) / n_data for k in params}
        loss = float(sum(r[1] for r in runs) / n_data)
    else:
        grads, loss, _ = T.grads_fn(cfg, rcfg, model, batch)
        loss = float(loss)
    return {"grads": {k: g.detach().clone() for k, g in grads.items()},
            "loss": loss}


def _unsharded_tokens(name):
    from repro_torch.serve.serve_step import generate
    cfg, rcfg, new = _decode_case(name)
    return generate(cfg, rcfg, M.init(cfg, 0, device="cpu"),
                    TP._serve_batch(cfg), max_new_tokens=new, device="cpu")


def _run(tmp_path_factory, mesh_name):
    dims = MESHES[mesh_name]
    world = dims[0] * dims[1]
    tmp = tmp_path_factory.mktemp(f"sp_{mesh_name}")
    if dims == (1, 2):
        refs = {name: TP._reference(name) for name in TP.SERVE_CASES}
        torch.save({k: w for k, (w, _) in refs.items()},
                   tmp / "serve_weights.pt")
    ctx = mp.start_processes(_rank, args=(world, str(tmp / "store"),
                                          str(tmp), dims),
                             nprocs=world, join=False, start_method="spawn")
    try:
        names = TP.CASES if dims == (1, 2) else CASES_2x2
        want = {name: _oracle(name, dims[0]) for name in names}
        if dims == (1, 2):
            want.update((f"odd:{k}", _oracle(k, 1, ODD_SEQ))
                        for k in FALLBACK)
            want.update((f"decode:{k}", _unsharded_tokens(k))
                        for k in DECODE)
            want.update((f"prefill:{k}", logits)
                        for k, (_, logits) in refs.items())
        deadline = time.monotonic() + TP.SPAWN_TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"the {mesh_name} gloo ranks did not finish in "
                            f"{TP.SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return torch.load(tmp / "rank0.pt"), want


def _ran(tmp_path_factory, name):
    return name, once(tmp_path_factory, f"sp_{name}",
                      lambda: _run(tmp_path_factory, name))


@pytest.fixture(scope="module")
def ran_1x2(tmp_path_factory):
    return _ran(tmp_path_factory, "1x2")


@pytest.fixture(scope="module")
def ran_2x2(tmp_path_factory):
    return _ran(tmp_path_factory, "2x2")


def _held(mesh, case, got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TP.LOSS_RTOL)
    assert set(got["grads"]) == set(want["grads"])
    for k, ref in want["grads"].items():
        if case == "whisper":
            bound = TP.BF16_STEP * float(ref.abs().max())
            assert float((got["grads"][k] - ref).abs().max()) <= bound, k
            continue
        torch.testing.assert_close(
            got["grads"][k], ref, rtol=TP.GRAD_RTOL, atol=TP.GRAD_ATOL,
            msg=lambda m, k=k: f"{mesh} {case} {k}: {m}")


def _stepped(mesh, case, got, seq=SEQ):
    cfg, rcfg = _case(case, seq)
    _, params, opt_state = T.init_train_state(cfg, rcfg, device="cpu")
    grads = {k: g.clone() for k, g in got["grads"].items()}
    grads, _ = T.clip_by_global_norm(grads, rcfg.grad_clip)
    params, _ = make_optimizer(rcfg).update(grads, opt_state, params, 0)
    for k, ref in params.items():
        torch.testing.assert_close(
            got["params"][k], ref.detach(), rtol=0, atol=TP.PARAM_ATOL,
            msg=lambda m, k=k: f"{mesh} {case} {k}: {m}")


@pytest.mark.parametrize("case", sorted(TP.CASES))
def test_sp_loss_and_gradients_match_unsharded(ran_1x2, case):
    mesh, (got, want) = ran_1x2
    _held(mesh, case, got[case], want[case])
    assert got[case]["scatters"] > 0      # the sequence-parallel program


@pytest.mark.parametrize("case", sorted(TP.CASES))
def test_sp_step_matches_unsharded(ran_1x2, case):
    mesh, (got, _) = ran_1x2
    _stepped(mesh, case, got[case])


@pytest.mark.parametrize("case", CASES_2x2)
def test_sp_on_data_and_model_matches_unsharded(ran_2x2, case):
    mesh, (got, want) = ran_2x2
    _held(mesh, case, got[case], want[case])
    _stepped(mesh, case, got[case])


@pytest.mark.parametrize("case", FALLBACK)
def test_sequence_two_does_not_divide_runs_tensor_parallel(ran_1x2, case):
    """At 15 positions the rules keep ``act_seq`` whole: the decoder runs
    the tensor-parallel program (no reduce-scatter over ``"model"`` on
    ``(1, 2)``), whisper's encoder still splits its 24 frames, and both
    match."""
    mesh, (got, want) = ran_1x2
    g = got[f"odd:{case}"]
    _held(mesh, case, g, want[f"odd:{case}"])
    _stepped(mesh, case, g, ODD_SEQ)
    assert (g["scatters"] > 0) == (case == "whisper")


def test_sp_forward_collectives(ran_1x2):
    """No ``[B, S, d]`` all-reduce; the all-gathers and reduce-scatters
    the design names, per layer and per forward."""
    _, (got, _) = ran_1x2
    cfg, rcfg = _case("qwen2")
    b, s, d = rcfg.shape.global_batch, SEQ, cfg.d_model
    kv, hd, h = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    log = got["forward"]
    assert log[-1] == ("total", len(log) - 1)   # every one a crossing's
    assert ("all-reduce", (b, s, d)) not in log
    weights = [(d, h, hd), (d, kv, hd), (d, kv, hd), (h, hd, d)]
    if cfg.qkv_bias:
        weights += [(h, hd), (kv, hd), (kv, hd)]
    per_layer = sorted(weights + [(b, s, kv, hd)] * 2 + [(b, s, d)])
    gathers = sorted(shp for k, shp in log if k == "all-gather")
    assert gathers == sorted(per_layer * cfg.num_layers + [(b, s, d)])
    scatters = sorted(shp for k, shp in log if k == "reduce-scatter")
    assert scatters == [(b, s // 2, d)] * (cfg.num_layers + 1)


@pytest.mark.parametrize("case", sorted(DECODE))
def test_decode_on_cache_seq_matches_unsharded(ran_1x2, case):
    _, (got, want) = ran_1x2
    g = got[f"decode:{case}"]
    for sp in (False, True):
        assert torch.equal(g[f"tokens_{sp}"], want[f"decode:{case}"]), sp
    cfg, _, new = _decode_case(case)
    kv, rings = cfg.num_kv_heads, {S + new}
    for path, shape in g["cache"].items():
        parent, _, name = path.rpartition(".")
        if name in ("k", "v"):          # W/2 slots of every kv head, or
            w = g["cache"][f"{parent}.pos" if parent else "pos"][-1]
            rings.add(w)                # W odd: half the kv heads
            want = (w // 2, kv) if w % 2 == 0 else (w, kv // 2)
            assert shape[2:4] == want, (path, shape)
        elif name in ("cross_k", "cross_v"):
            assert shape[2:4] == (cfg.encoder_seq // 2, kv), (path, shape)
    assert g["step"][-1] == ("total", len(g["step"]) - 1)
    for kind, shape in g["step"][:-1]:  # no result holds a whole ring
        assert not rings & set(shape), (kind, shape)


@pytest.mark.parametrize("case", TP.SERVE_CASES)
def test_sp_prefill_matches_reference_forward(ran_1x2, case):
    _, (got, want) = ran_1x2
    cfg, _ = TP._case(case)
    v = cfg.vocab_size
    err = float((got[f"prefill:{case}"]["logits"][..., :v]
                 - want[f"prefill:{case}"][..., :v]).abs().max())
    assert err < TP.REF_ATOL, err


# ---------------------------------------------------------------------------
# Module parity with the JAX package, no spawn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("half", (0, 1))
@pytest.mark.parametrize("window", (None, 24))
def test_local_query_core_matches_reference_rows(half, window):
    """One rank's queries (half of 96 positions) against every key,
    chunked over the keys, equal the reference's ``kv_chunk_only`` core
    on those rows."""
    import jax.numpy as jnp
    from repro.models import attention as ja
    b, s, h, d = 2, 96, 4, 16
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    want = np.asarray(ja.attention_core(
        *map(jnp.asarray, (q, k, v, pos, pos)), window=window, chunk=32,
        kv_chunk_only=True))
    lo, hi = half * s // 2, (half + 1) * s // 2
    got = ta.attention_core(
        *map(torch.from_numpy, (q[:, lo:hi], k, v, pos[:, lo:hi], pos)),
        window=window, chunk=32, kv_chunk_only=True).numpy()
    err = np.abs(got - want[:, lo:hi]).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize("arch,window,softcap", [
    ("qwen2-1.5b", None, None), ("gemma2-27b", 16, 50.0)])
def test_two_part_decode_combine_matches_reference(arch, window, softcap):
    """A ring of 32 slots split in two parts, the second all empty (pos
    -1, a short prompt early in a decode), with the window and the
    softcap applied per slot: :func:`softmax_part` on each and
    :func:`merge_parts` equal the reference's ``attn_decode`` on the whole
    cache, rtol 1e-5; then again with both parts filled."""
    import jax
    import jax.numpy as jnp
    from repro.configs.archs import ARCHS as JARCHS
    from repro.configs.base import smoke_model as jsmoke
    from repro.models import attention as ja
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.base import smoke_model
    over = {"attn_softcap": softcap}
    jcfg = dataclasses.replace(jsmoke(JARCHS[arch]), **over)
    cfg = dataclasses.replace(smoke_model(ARCHS[arch]), **over)
    jp, _ = ja.attn_init(jcfg, jax.random.PRNGKey(0))
    p = ta.Attention(cfg, torch.Generator().manual_seed(0))
    p.load_state_dict({k: torch.from_numpy(np.array(x))
                       for k, x in jp.items()})
    b, w, kv, hd = 2, 32, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(5)
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(b, w, kv, hd)).astype(np.float32)
    cv = rng.normal(size=(b, w, kv, hd)).astype(np.float32)
    call = ta.AttnCall(window=window)
    for filled in (10, 30):
        pos = filled
        cp = np.where(np.arange(w) < filled, np.arange(w), -1).astype(
            np.int32)
        want, jk, jv, jpos = ja.attn_decode(
            jcfg, jp, jnp.asarray(x), pos, jnp.asarray(ck), jnp.asarray(cv),
            jnp.asarray(cp), ja.AttnCall(window=window))
        with torch.no_grad():
            positions = torch.full((b, 1), pos, dtype=torch.int32)
            q = ta.project_q(cfg, p, torch.from_numpy(x), positions)
            q = q * (hd ** -0.5)
            kf = ta.repeat_kv(torch.from_numpy(np.array(jk)), cfg.num_heads)
            vf = ta.repeat_kv(torch.from_numpy(np.array(jv)), cfg.num_heads)
            k_pos = torch.from_numpy(np.array(jpos))[None].expand(b, w)
            parts = [ta.softmax_part(
                q, kf[:, i:i + w // 2], vf[:, i:i + w // 2], positions,
                k_pos[:, i:i + w // 2], causal=True, window=window,
                softcap_val=softcap) for i in (0, w // 2)]
            if filled < w // 2:       # the second part holds no key
                assert float(parts[1][1].abs().max()) == 0.0
            m, l, acc = (torch.stack(t) for t in zip(*parts))
            out = ta.merge_parts(m, l, acc,
                                 lambda t: t.amax(0, keepdim=True),
                                 lambda t: t.sum(0))
            got = ta._out(p, out, torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
