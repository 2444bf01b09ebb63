"""Decoder LM over a repeating layer pattern: the Mamba2 (``family="ssm"``)
path of ``repro.models.lm``.

The stack is ``num_layers`` layers, layer ``l`` of kind
``cfg.full_pattern[l % len(pattern)]``, run one after another in a Python
loop (the reference scans over ``num_blocks`` repeats of the pattern).
Caches keep the reference's layout: a list over pattern positions ``i``,
each a dict of tensors stacked over blocks ``j``, so ``cache[i][k][j]``
belongs to layer ``j * len(pattern) + i``.

Ported: Mamba mixers with no MLP, for train, prefill and decode.  The
attention mixers, the dense and MoE MLPs, post-norms and frontends raise
:class:`NotImplementedError` (ROADMAP Queue 1 item 9).  The reference's
sharding constraints have no counterpart: the port runs on one card.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models.ssm import Mamba2Mixer, ssm_apply, ssm_decode


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a config that needs a path the port does not have yet."""
    for spec in cfg.full_pattern:
        if spec.mixer != "mamba":
            raise L.not_ported(f"the {spec.mixer!r} mixer")
        if spec.mlp != "none":
            raise L.not_ported(f"the {spec.mlp!r} MLP")
    if cfg.use_post_norm:
        raise L.not_ported("post-norms (gemma2)")
    if cfg.frontend:
        raise L.not_ported(f"the {cfg.frontend!r} frontend stub")


class Layer(nn.Module):
    """The pre-norm ``norm1`` and a Mamba2 ``mixer``."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, *,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = nn.Parameter(torch.ones(cfg.d_model,
                                             device=generator.device,
                                             dtype=dtype))
        self.mixer = Mamba2Mixer(cfg, generator, dtype=dtype)


class LM(nn.Module):
    """``embed``, ``layers`` and ``final_norm``, drawn from ``generator``
    on its device."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, *,
                 dtype=torch.float32):
        super().__init__()
        check_ported(cfg)
        self.embed = L.Embedding(cfg, generator, dtype=dtype)
        self.layers = nn.ModuleList(
            Layer(cfg, generator, dtype=dtype) for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.ones(
            cfg.d_model, device=generator.device, dtype=dtype))


def apply_layer(cfg: ModelConfig, rcfg: RunConfig, p: Layer, x, *,
                cache=None, mode: str = "train"):
    """One layer.  Returns (x, new cache entry); the entry is None in
    ``"train"`` mode.  The prefill's conv state is stored in bf16, as the
    reference stores it; decode returns it in the compute dtype."""
    h = L.rmsnorm(x, p.norm1, cfg.norm_eps)
    if mode == "decode":
        y, (cs, hs) = ssm_decode(cfg, p.mixer, h, cache["conv"],
                                 cache["ssm"])
        new_cache = {"conv": cs, "ssm": hs}
    else:
        y, (cs, hs) = ssm_apply(cfg, p.mixer, h, use_pallas=rcfg.use_pallas)
        new_cache = ({"conv": cs.to(torch.bfloat16), "ssm": hs}
                     if mode == "prefill" else None)
    return x + y, new_cache


def _stack(cfg: ModelConfig, entries: list[dict]) -> list[dict]:
    """Per-layer cache entries -> the reference's layout."""
    n = len(cfg.full_pattern)
    return [{k: torch.stack([entries[j * n + i][k]
                             for j in range(cfg.num_blocks)])
             for k in entries[i]} for i in range(n)]


def _embed_in(cfg: ModelConfig, rcfg: RunConfig, model: LM, tokens,
              pos_offset: int = 0):
    x = L.embed_tokens(cfg, model.embed, tokens,
                       getattr(torch, rcfg.compute_dtype))
    b, s, _ = x.shape
    positions = (torch.arange(s, dtype=torch.int32, device=x.device)
                 + pos_offset).expand(b, s)
    return L.add_positions(cfg, model.embed, x, positions)


def forward(cfg: ModelConfig, rcfg: RunConfig, model: LM, tokens,
            mode: str = "train"):
    """tokens: [B, S] -> (logits [B, S, V], cache or None).

    ``mode="prefill"`` also returns the stacked SSM cache."""
    x = _embed_in(cfg, rcfg, model, tokens)
    entries = []
    for layer in model.layers:
        x, entry = apply_layer(cfg, rcfg, layer, x, mode=mode)
        entries.append(entry)
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = L.lm_logits(cfg, model.embed, x)
    return logits, (_stack(cfg, entries) if mode == "prefill" else None)


def init_cache(cfg: ModelConfig, rcfg: RunConfig, batch: int, max_len: int,
               *, device) -> list[dict]:
    """Zero cache for decoding from scratch (the prefill's shapes).
    ``max_len`` sizes attention caches; SSM states are fixed-size."""
    check_ported(cfg)
    nb = cfg.num_blocks
    conv = (nb, batch, cfg.ssm_conv_kernel - 1,
            cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
    ssm = (nb, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    return [{"conv": torch.zeros(conv, dtype=torch.bfloat16, device=device),
             "ssm": torch.zeros(ssm, dtype=torch.float32, device=device)}
            for _ in cfg.full_pattern]


def decode_step(cfg: ModelConfig, rcfg: RunConfig, model: LM, cache, token,
                pos: int):
    """token: [B, 1] at position ``pos``.  Returns (logits [B, 1, V], the
    new cache)."""
    x = _embed_in(cfg, rcfg, model, token, pos_offset=pos)
    n = len(cfg.full_pattern)
    entries = []
    for l, layer in enumerate(model.layers):
        entry = {k: v[l // n] for k, v in cache[l % n].items()}
        x, entry = apply_layer(cfg, rcfg, layer, x, cache=entry,
                               mode="decode")
        entries.append(entry)
    x = L.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return L.lm_logits(cfg, model.embed, x), _stack(cfg, entries)
