"""Encoder-decoder backbone (whisper-small): port of
``repro.models.encdec``.

The conv/mel frontend is a stub, as in the reference: the caller gives
precomputed frame embeddings [B, encoder_seq, d_model].  The encoder is a
bidirectional attention stack with its own position table ``enc_pos``;
the decoder is causal self-attention, cross-attention and an MLP per
layer, with learned positions.  The cross K/V are computed once at
prefill and kept in the cache.  The cache is one dict of tensors stacked
over the decoder layers: ``k``, ``v`` (bf16), ``pos``, ``cross_k``,
``cross_v`` (bf16).  Under autograd every encoder and decoder layer runs
under :func:`repro_torch.models.lm.remat`.  On a mesh the attention and
MLPs of both stacks, the cross K/V projections among them, compute on
this rank's heads and MLP shard where the rules split them
(:mod:`repro_torch.models.attention`, :func:`~repro_torch.models.layers.
mlp_apply`); the prefill's cache holds the rank's kv heads (every kv
head under sequence parallelism, which each stack applies where its own
sequence divides).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.lm import (_constraint, _embed_in, _merge_metrics,
                                   remat, seq_parallel_shard)
from repro_torch.runtime import sharding as shd


class EncLayer(nn.Module):
    """``norm1``, the self-attention ``mixer``, ``norm2`` and ``mlp``."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, *,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = L.ones(cfg.d_model, generator, dtype)
        self.mixer = attn.Attention(cfg, generator, dtype=dtype)
        self.norm2 = L.ones(cfg.d_model, generator, dtype)
        self.mlp = L.MLP(cfg, generator, dtype=dtype)


class DecLayer(EncLayer):
    """An encoder layer plus ``norm_cross`` and the ``cross`` attention."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, *,
                 dtype=torch.float32):
        super().__init__(cfg, generator, dtype=dtype)
        self.norm_cross = L.ones(cfg.d_model, generator, dtype)
        self.cross = attn.Attention(cfg, generator, dtype=dtype)


class EncDec(nn.Module):
    """``embed``, ``enc_pos`` [encoder_seq, d], ``encoder`` and
    ``decoder`` layers, ``enc_final_norm`` and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, *,
                 dtype=torch.float32):
        super().__init__()
        self.embed = L.Embedding(cfg, generator, dtype=dtype)
        self.enc_pos = L.dense_init((cfg.encoder_seq, cfg.d_model),
                                    generator, scale=0.02, dtype=dtype)
        self.encoder = nn.ModuleList(EncLayer(cfg, generator, dtype=dtype)
                                     for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(DecLayer(cfg, generator, dtype=dtype)
                                     for _ in range(cfg.num_layers))
        self.enc_final_norm = L.ones(cfg.d_model, generator, dtype)
        self.final_norm = L.ones(cfg.d_model, generator, dtype)


def encode(cfg: ModelConfig, rcfg: RunConfig, model: EncDec, frames,
           sp=None):
    """frames: [B, Se, d] stub embeddings -> encoder states [B, Se, d];
    under sequence parallelism (``sp``, the encoder's) this rank's
    positions of them."""
    cd = getattr(torch, rcfg.compute_dtype)
    b, s = frames.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=frames.device)[None].expand(b, s)
    enc_pos = shd.split_seq(model.enc_pos[None], sp)
    if sp is not None:
        frames = frames[:, sp.start:sp.stop]
    x = frames.to(cd) + enc_pos.to(cd)
    layer_fn = remat(_enc_layer, rcfg)
    for p in model.encoder:
        x = layer_fn(cfg, p, x, positions, sp)
    return L.rmsnorm(x, shd.copy_to_model(model.enc_final_norm, sp),
                     cfg.norm_eps)


def _norm(cfg: ModelConfig, x, w, sp):
    return L.rmsnorm(x, shd.copy_to_model(w, sp), cfg.norm_eps)


def _enc_layer(cfg: ModelConfig, p: EncLayer, x, positions, sp=None):
    call = attn.AttnCall(causal=False, window=None, use_rope=False)
    h = _norm(cfg, x, p.norm1, sp)
    y, _ = attn.attn_apply(cfg, p.mixer, h, positions, call, sp=sp)
    x = x + y
    h = _norm(cfg, x, p.norm2, sp)
    return _constraint(x + L.mlp_apply(cfg, p.mlp, h, sp),
                       ("batch", "seq", "act_embed"))


def _cross_kv(cfg: ModelConfig, p: DecLayer, enc, sp=None):
    k, v = attn.cross_kv(cfg, p.cross, enc, sp)
    return k.to(torch.bfloat16), v.to(torch.bfloat16)


def _dec_layer(cfg: ModelConfig, p: DecLayer, x, positions, enc, mode: str,
               sp=None):
    """One decoder layer; returns (x, its prefill cache entry or None).
    Under sequence parallelism (``sp``) ``x`` holds this rank's positions
    and ``enc`` the whole encoder sequence (see :func:`_enc_for_decoder`);
    the cross K/V, of every kv head, go to the cache as they are."""
    call = attn.AttnCall(causal=True, window=None, use_rope=False)
    h = _norm(cfg, x, p.norm1, sp)
    y, (k, v) = attn.attn_apply(cfg, p.mixer, h, positions, call, sp=sp)
    x = x + y
    ck, cv = _cross_kv(cfg, p, enc, sp)
    h = _norm(cfg, x, p.norm_cross, sp)
    x = x + attn.cross_attn_apply(cfg, p.cross, h, ck, cv, sp)
    h = _norm(cfg, x, p.norm2, sp)
    x = _constraint(x + L.mlp_apply(cfg, p.mlp, h, sp),
                    ("batch", "seq", "act_embed"))
    if mode != "prefill":
        return x, None
    return x, {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16),
               "pos": positions[0].to(torch.int32), "cross_k": ck,
               "cross_v": cv}


def forward(cfg: ModelConfig, rcfg: RunConfig, model: EncDec, tokens,
            frames, mode: str = "train"):
    """Teacher-forced decoder over the encoder states.  Returns (logits,
    cache or None, metrics); the cache only with ``mode="prefill"``.
    Under sequence parallelism the encoder and the decoder each split
    their sequence where the rules split it (the encoder's and the
    decoder's lengths may fall back apart)."""
    frames = frames.to(model.enc_pos.device)
    enc_sp = seq_parallel_shard(rcfg, model, frames.shape[1], mode)
    sp = seq_parallel_shard(rcfg, model, tokens.shape[1], mode)
    enc = _enc_for_decoder(encode(cfg, rcfg, model, frames, enc_sp), enc_sp,
                           sp, model)
    x, positions = _embed_in(cfg, rcfg, model, tokens, sp=sp)
    layer_fn = remat(_dec_layer, rcfg)
    entries = []
    for p in model.decoder:
        x, entry = layer_fn(cfg, p, x, positions, enc, mode, sp)
        entries.append(entry)
    x = _norm(cfg, x, model.final_norm, sp)
    logits = _constraint(L.lm_logits(cfg, model.embed, x, sp),
                         ("batch", "seq", "vocab"))
    cache = ({k: torch.stack([e[k] for e in entries]) for k in entries[0]}
             if mode == "prefill" else None)
    return logits, cache, _merge_metrics([], x.device)


def _enc_for_decoder(enc, enc_sp, sp, model):
    """The encoder states as every decoder layer's cross K/V read them:
    whole.  Local positions are gathered, the gradient reduce-scattered
    where the decoder runs sequence-parallel (its cross attention's
    gradient is a partial sum over its positions) or sliced where it runs
    tensor-parallel (the same on every rank); whole states enter the
    decoder's positions with their gradient all-reduced."""
    if enc_sp is None:
        return shd.copy_to_model(enc, sp)
    if sp is None:
        return shd.gather_from_model(enc, enc_sp)
    return shd.gather_seq(enc, enc_sp)


def init_cache(cfg: ModelConfig, rcfg: RunConfig, batch: int, max_len: int,
               *, device) -> dict:
    n, bf16 = cfg.num_layers, torch.bfloat16
    kv = (n, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    cross = (n, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=bf16, device=device),
            "v": torch.zeros(kv, dtype=bf16, device=device),
            "pos": torch.full((n, max_len), -1, dtype=torch.int32,
                              device=device),
            "cross_k": torch.zeros(cross, dtype=bf16, device=device),
            "cross_v": torch.zeros(cross, dtype=bf16, device=device)}


def decode_step(cfg: ModelConfig, rcfg: RunConfig, model: EncDec, cache,
                token, pos: int):
    """token: [B, 1]; one step against the cached self and cross K/V.
    Returns (logits [B, 1, V], the new cache)."""
    x, _ = _embed_in(cfg, rcfg, model, token, pos_offset=pos)
    call = attn.AttnCall(causal=True, window=None, use_rope=False)
    ks, vs, ps = [], [], []
    for l, p in enumerate(model.decoder):
        h = L.rmsnorm(x, p.norm1, cfg.norm_eps)
        y, ck, cv, cp = attn.attn_decode(cfg, p.mixer, h, pos,
                                         cache["k"][l], cache["v"][l],
                                         cache["pos"][l], call)
        x = x + y
        h = L.rmsnorm(x, p.norm_cross, cfg.norm_eps)
        x = x + attn.cross_attn_apply(cfg, p.cross, h, cache["cross_k"][l],
                                      cache["cross_v"][l])
        h = L.rmsnorm(x, p.norm2, cfg.norm_eps)
        x = x + L.mlp_apply(cfg, p.mlp, h)
        ks.append(ck)
        vs.append(cv)
        ps.append(cp)
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    new_cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "pos": torch.stack(ps), "cross_k": cache["cross_k"],
                 "cross_v": cache["cross_v"]}
    return L.lm_logits(cfg, model.embed, x), new_cache
