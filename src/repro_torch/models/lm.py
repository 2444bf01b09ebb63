"""Decoder LM over a repeating heterogeneous layer pattern: port of
``repro.models.lm``.

One code path serves every decoder-only family (dense, moe, hybrid, ssm,
vlm with its patch-prefix stub); whisper lives in
:mod:`repro_torch.models.encdec`.  The stack is ``num_layers`` layers,
layer ``l`` of kind ``cfg.full_pattern[l % len(pattern)]``, each an
attention (``attn``/``attn_local``) or Mamba2 mixer and a dense, MoE or
no MLP, run one after another in a Python loop (the reference scans over
``num_blocks`` repeats of the pattern).  Caches keep the reference's
layout: a list over pattern positions ``i``, each a dict of tensors
stacked over blocks ``j``, so ``cache[i][k][j]`` belongs to layer
``j * len(pattern) + i``.  ``_constraint`` is the reference's sharding
hook (:func:`repro_torch.runtime.sharding.logical_constraint` under the
training rules), called where the reference calls it: it redistributes a
DTensor activation to the rules' layout and passes a plain tensor, which
is what the sharded runs compute on (each layer reads its weights'
``"model"`` shards and computes tensor-parallel; see
:mod:`repro_torch.runtime.sharding`).  With ``rcfg.seq_parallel``, where
the rules split ``act_seq``, the layers run sequence-parallel
(:func:`seq_parallel_shard`, :func:`apply_layer`): the residual stream
holds each rank's positions.

Under autograd, :func:`remat` wraps each layer as the reference's
``_remat`` wraps its scanned block: ``"full"`` keeps only the layer's
inputs and recomputes the rest in the backward, ``"dots"`` also keeps the
outputs of matmuls without batch dims (``aten.mm``/``addmm``, as
``dots_with_no_batch_dims_saveable``), ``"none"`` keeps everything.  The
recomputation runs the layer's Python again, so an MoE layer plans its
buckets (and launches the bucket-count kernel) a second time; the plan
is the same, since the sort is stable and the counts exact.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import LayerSpec, ModelConfig, RunConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.ssm import Mamba2Mixer, ssm_apply, ssm_decode
from repro_torch.moe import moe_layer
from repro_torch.runtime import sharding as shd

RULES = shd.ShardingRules(shd.TRAIN_RULES)
CACHE_KV_AXES = ("batch", "cache_seq", "kv_heads", "head_dim")


def _constraint(x, axes):
    return shd.logical_constraint(RULES, x, axes)


class Layer(nn.Module):
    """``norm1`` and the ``mixer``; ``post_norm1`` with post-norms; with an
    MLP, ``norm2``, the ``mlp`` (dense or MoE) and ``post_norm2``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 generator: torch.Generator, *, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        self.norm1 = L.ones(d, generator, dtype)
        if spec.mixer in ("attn", "attn_local"):
            self.mixer = attn.Attention(cfg, generator, dtype=dtype)
        elif spec.mixer == "mamba":
            self.mixer = Mamba2Mixer(cfg, generator, dtype=dtype)
        else:
            raise ValueError(spec.mixer)
        if cfg.use_post_norm:
            self.post_norm1 = L.ones(d, generator, dtype)
        if spec.mlp != "none":
            self.norm2 = L.ones(d, generator, dtype)
            if spec.mlp == "dense":
                self.mlp = L.MLP(cfg, generator, dtype=dtype)
            elif spec.mlp == "moe":
                self.mlp = moe_layer.MoE(cfg, generator, dtype=dtype)
            else:
                raise ValueError(spec.mlp)
            if cfg.use_post_norm:
                self.post_norm2 = L.ones(d, generator, dtype)


class LM(nn.Module):
    """``embed``, ``layers`` and ``final_norm``, drawn from ``generator``
    on its device."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, *,
                 dtype=torch.float32):
        super().__init__()
        pattern = cfg.full_pattern
        self.embed = L.Embedding(cfg, generator, dtype=dtype)
        self.layers = nn.ModuleList(
            Layer(cfg, pattern[l % len(pattern)], generator, dtype=dtype)
            for l in range(cfg.num_layers))
        self.final_norm = L.ones(cfg.d_model, generator, dtype)


# ---------------------------------------------------------------------------
# Layer application (shared by train forward / prefill / decode)
# ---------------------------------------------------------------------------


def _attn_call(cfg: ModelConfig, spec: LayerSpec) -> attn.AttnCall:
    window = cfg.sliding_window if spec.mixer == "attn_local" else None
    return attn.AttnCall(causal=True, window=window,
                         use_rope=cfg.pos_embedding == "rope")


def apply_layer(cfg: ModelConfig, rcfg: RunConfig, spec: LayerSpec,
                p: Layer, x, positions, cache=None, pos=None,
                mode: str = "train", sp=None):
    """One layer.  Returns (x, new cache entry, metrics); the entry is
    None in ``"train"`` mode, metrics are the MoE's (empty otherwise).
    The prefill stores K/V and the Mamba conv state in bf16, as the
    reference does; decode returns the conv state in the compute dtype.

    Under sequence parallelism ``sp`` (a :class:`~repro_torch.runtime.
    sharding.ModelShard` of the sequence dim) ``x`` holds this rank's
    positions of the whole sequence's ``positions``: the norms and
    residual adds run on them (the norm weights' gradients are partial
    sums, all-reduced), and each mixer and MLP crosses to the whole
    sequence and back as its layout needs."""
    metrics = {}
    zc = cfg.use_post_norm

    def norm(t, w, zero_centered=zc):
        return L.rmsnorm(t, shd.copy_to_model(w, sp), cfg.norm_eps,
                         zero_centered=zero_centered)
    h = norm(x, p.norm1)
    if spec.mixer in ("attn", "attn_local"):
        call = _attn_call(cfg, spec)
        if mode == "decode":
            y, ck, cv, cp = attn.attn_decode(
                cfg, p.mixer, h, pos, cache["k"], cache["v"], cache["pos"],
                call)
            new_cache = {"k": _constraint(ck, CACHE_KV_AXES),
                         "v": _constraint(cv, CACHE_KV_AXES), "pos": cp}
        else:
            y, (k, v) = attn.attn_apply(
                cfg, p.mixer, h, positions, call,
                causal_skip=rcfg.attn_causal_skip,
                seq_parallel=rcfg.seq_parallel, sp=sp)
            new_cache = _prefill_cache(cfg, spec, k, v, positions, mode)
    else:  # mamba
        if mode == "decode":
            y, (cs, hs) = ssm_decode(cfg, p.mixer, h, cache["conv"],
                                     cache["ssm"])
            new_cache = {"conv": cs, "ssm": hs}
        else:
            y, (cs, hs) = ssm_apply(cfg, p.mixer, h,
                                    use_pallas=rcfg.use_pallas, sp=sp)
            new_cache = ({"conv": cs.to(torch.bfloat16), "ssm": hs}
                         if mode == "prefill" else None)
    if cfg.use_post_norm:
        y = norm(y, p.post_norm1, True)
    x = x + y
    if spec.mlp != "none":
        h = norm(x, p.norm2)
        if spec.mlp == "dense":
            y = L.mlp_apply(cfg, p.mlp, h, sp)
        elif sp is not None:
            y, metrics = moe_layer.moe_apply_seq(cfg, p.mlp, h, sp,
                                                 impl=rcfg.moe_impl,
                                                 mode=mode)
        else:
            b, s, d = h.shape
            y2d, metrics = moe_layer.moe_apply(cfg, p.mlp,
                                               h.reshape(b * s, d),
                                               impl=rcfg.moe_impl, mode=mode)
            y = y2d.reshape(b, s, d)
        if cfg.use_post_norm:
            y = norm(y, p.post_norm2, True)
        x = x + y
    seq_ax = "act_seq" if (rcfg.seq_parallel and mode != "decode") else "seq"
    x = _constraint(x, ("batch", seq_ax, "act_embed"))
    return x, new_cache, metrics


def _prefill_cache(cfg: ModelConfig, spec: LayerSpec, k, v, positions,
                   mode: str):
    if mode != "prefill":
        return None
    # local layers keep only the trailing window (ring layout: slot = pos % W)
    s = k.shape[1]
    if spec.mixer == "attn_local" and cfg.sliding_window and \
            cfg.sliding_window < s:
        w = cfg.sliding_window
        k, v = k[:, -w:], v[:, -w:]
        pos_slice = positions[0, -w:]
        # re-order so slot i holds the position with pos % w == i
        order = torch.argsort(pos_slice % w, stable=True)
        k, v, pos_slice = k[:, order], v[:, order], pos_slice[order]
    else:
        pos_slice = positions[0]
    return {"k": _constraint(k.to(torch.bfloat16), CACHE_KV_AXES),
            "v": _constraint(v.to(torch.bfloat16), CACHE_KV_AXES),
            "pos": pos_slice.to(torch.int32)}


def _stack(cfg: ModelConfig, entries: list[dict]) -> list[dict]:
    """Per-layer cache entries -> the reference's layout."""
    n = len(cfg.full_pattern)
    return [{k: torch.stack([entries[j * n + i][k]
                             for j in range(cfg.num_blocks)])
             for k in entries[i]} for i in range(n)]


# ---------------------------------------------------------------------------
# Full forward (train / prefill) and decode
# ---------------------------------------------------------------------------


def seq_parallel_shard(rcfg: RunConfig, model, length: int, mode: str):
    """This rank's positions of a sequence of ``length`` under sequence
    parallelism: with ``rcfg.seq_parallel`` outside decode, where the
    rules split ``act_seq`` over the model's ``"model"`` axis; else None
    (no mesh, or the divisibility fallback), and the layers run the
    tensor-parallel program."""
    if not rcfg.seq_parallel or mode == "decode":
        return None
    return shd.seq_shard(model.embed, length, "act_seq", rules=RULES)


def _embed_in(cfg: ModelConfig, rcfg: RunConfig, model, tokens,
              extra_embeds=None, pos_offset: int = 0, sp=None):
    """Token embeddings (after the ``extra_embeds`` prefix, the vlm/audio
    stub) and their positions [B, S] int32.  Under sequence parallelism
    (``sp``) the embeddings of this rank's positions of the whole
    sequence: a vocab-parallel lookup's partial rows summed onto them
    (``scatter_seq``, the prefix counted on the group's first rank), a
    whole one split; the positions stay whole."""
    cd = getattr(torch, rcfg.compute_dtype)
    vocab = L.embed_shard(model.embed) if sp is not None else None
    x = L.embed_tokens(cfg, model.embed, tokens, cd,
                       partial=vocab is not None)
    if extra_embeds is not None:
        prefix = extra_embeds.to(device=x.device, dtype=cd)
        if vocab is not None and \
                vocab.group[0].get_local_rank(vocab.group[1]):
            prefix = torch.zeros_like(prefix)
        x = torch.cat([prefix, x], dim=1)
    b, s, _ = x.shape
    positions = (torch.arange(s, dtype=torch.int32, device=x.device)
                 + pos_offset).expand(b, s)
    if sp is not None:
        x = (shd.scatter_seq(x, sp) if vocab is not None
             else shd.split_seq(x, sp))
        return L.add_positions(cfg, model.embed, x, positions, sp), \
            positions
    x = L.add_positions(cfg, model.embed, x, positions)
    return _constraint(x, ("batch", "seq", "act_embed")), positions


def _merge_metrics(mets: list[dict], device) -> dict:
    """The layers' MoE metrics summed; zeros where no layer has an MoE."""
    out: dict[str, torch.Tensor] = {}
    for m in mets:
        for k_, v_ in m.items():
            out[k_] = out[k_] + v_ if k_ in out else v_
    if not out:
        out = {"moe_dropped": torch.zeros((), dtype=torch.int32,
                                          device=device),
               "moe_aux": torch.zeros((), dtype=torch.float32,
                                      device=device)}
    return out


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, rcfg: RunConfig):
    """``fn`` under ``rcfg.remat`` (``"none"``, ``"full"`` or ``"dots"``);
    without autograd ``fn`` itself, since nothing is saved then."""
    if rcfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat={rcfg.remat!r} not in none/full/dots")
    if rcfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    extra = ({} if rcfg.remat == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)})
    return functools.partial(checkpoint, fn, use_reentrant=False, **extra)


def forward(cfg: ModelConfig, rcfg: RunConfig, model: LM, tokens,
            extra_embeds=None, mode: str = "train"):
    """tokens: [B, S] -> (logits [B, S', V], cache or None, metrics).

    S' = S plus the ``extra_embeds`` prefix.  ``mode="prefill"`` also
    returns the stacked KV/SSM cache.  Metrics stay on the device.  Under
    sequence parallelism (:func:`seq_parallel_shard`) the layers and the
    final norm run on this rank's positions, and the sequence is gathered
    whole before the head: the logits and the cache cover every
    position."""
    length = tokens.shape[1] + (0 if extra_embeds is None
                                else extra_embeds.shape[1])
    sp = seq_parallel_shard(rcfg, model, length, mode)
    x, positions = _embed_in(cfg, rcfg, model, tokens, extra_embeds, sp=sp)
    pattern = cfg.full_pattern
    layer_fn = remat(apply_layer, rcfg)
    entries, mets = [], []
    for l, layer in enumerate(model.layers):
        x, entry, met = layer_fn(cfg, rcfg, pattern[l % len(pattern)],
                                 layer, x, positions, mode=mode, sp=sp)
        entries.append(entry)
        mets.append(met)
    x = L.rmsnorm(x, shd.copy_to_model(model.final_norm, sp), cfg.norm_eps,
                  zero_centered=cfg.use_post_norm)
    logits = _constraint(L.lm_logits(cfg, model.embed, x, sp),
                         ("batch", "seq", "vocab"))
    cache = _stack(cfg, entries) if mode == "prefill" else None
    return logits, cache, _merge_metrics(mets, x.device)


def init_cache(cfg: ModelConfig, rcfg: RunConfig, batch: int, max_len: int,
               *, device) -> list[dict]:
    """Zero cache for decoding from scratch (the prefill's shapes):
    attention K/V bf16 [B, W, KV, D] with every ``pos`` -1 (W = max_len,
    or the window for local layers); SSM states fixed-size."""
    nb, bf16 = cfg.num_blocks, torch.bfloat16
    entries = []
    for spec in cfg.full_pattern:
        if spec.mixer in ("attn", "attn_local"):
            w = max_len
            if spec.mixer == "attn_local" and cfg.sliding_window:
                w = min(max_len, cfg.sliding_window)
            kv = (nb, batch, w, cfg.num_kv_heads, cfg.head_dim)
            e = {"k": torch.zeros(kv, dtype=bf16, device=device),
                 "v": torch.zeros(kv, dtype=bf16, device=device),
                 "pos": torch.full((nb, w), -1, dtype=torch.int32,
                                   device=device)}
        else:
            conv = (nb, batch, cfg.ssm_conv_kernel - 1,
                    cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
            ssm = (nb, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
            e = {"conv": torch.zeros(conv, dtype=bf16, device=device),
                 "ssm": torch.zeros(ssm, dtype=torch.float32, device=device)}
        entries.append(e)
    return entries


def decode_step(cfg: ModelConfig, rcfg: RunConfig, model: LM, cache, token,
                pos: int):
    """token: [B, 1] at position ``pos``.  Returns (logits [B, 1, V], the
    new cache)."""
    x, _ = _embed_in(cfg, rcfg, model, token, pos_offset=pos)
    pattern = cfg.full_pattern
    n = len(pattern)
    entries = []
    for l, layer in enumerate(model.layers):
        entry = {k: v[l // n] for k, v in cache[l % n].items()}
        x, entry, _ = apply_layer(cfg, rcfg, pattern[l % n], layer, x, None,
                                  cache=entry, pos=pos, mode="decode")
        entries.append(entry)
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps,
                  zero_centered=cfg.use_post_norm)
    return L.lm_logits(cfg, model.embed, x), _stack(cfg, entries)
