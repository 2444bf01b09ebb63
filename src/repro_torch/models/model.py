"""Model API: init, prefill, decode.  Port of ``repro.models.model`` for
the decoder-only families the port runs (Mamba2 so far).

The encoder-decoder family raises :class:`NotImplementedError` (ROADMAP
Queue 1 item 9); ``loss_fn`` and ``input_specs`` wait for training.
Prefill and decode run without autograd.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import lm
from repro_torch.models.layers import not_ported


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encoder_layers > 0


def _decoder_only(cfg: ModelConfig) -> None:
    if is_encdec(cfg):
        raise not_ported("the encoder-decoder family (whisper)")


def init(cfg: ModelConfig, seed: int = 0, param_dtype=torch.float32, *,
         device="cuda") -> lm.LM:
    """Random weights drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed``."""
    _decoder_only(cfg)
    generator = torch.Generator(device=resolve_device(device))
    generator.manual_seed(seed)
    return lm.LM(cfg, generator, dtype=param_dtype)


@torch.no_grad()
def prefill(cfg: ModelConfig, rcfg: RunConfig, model: lm.LM, batch):
    """batch: {"tokens": [B, S]}.  Returns (last logits [B, 1, V],
    cache)."""
    _decoder_only(cfg)
    logits, cache = lm.forward(cfg, rcfg, model, batch["tokens"],
                               mode="prefill")
    return logits[:, -1:], cache


def init_cache(cfg: ModelConfig, rcfg: RunConfig, batch: int, max_len: int,
               *, device="cuda"):
    _decoder_only(cfg)
    return lm.init_cache(cfg, rcfg, batch, max_len,
                         device=resolve_device(device))


@torch.no_grad()
def decode_step(cfg: ModelConfig, rcfg: RunConfig, model: lm.LM, cache,
                token, pos: int):
    _decoder_only(cfg)
    return lm.decode_step(cfg, rcfg, model, cache, token, pos)
