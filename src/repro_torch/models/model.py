"""Model API: init, prefill, decode across every family.  Port of
``repro.models.model``: the encoder-decoder family (whisper) goes to
:mod:`repro_torch.models.encdec`, every other one to
:mod:`repro_torch.models.lm`.

``loss_fn``, ``input_specs``, ``cache_specs`` and ``param_specs`` wait for
training (ROADMAP Queue 1 item 9).  Prefill and decode run without
autograd.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import encdec, lm


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encoder_layers > 0


def init(cfg: ModelConfig, seed: int = 0, param_dtype=torch.float32, *,
         device="cuda"):
    """Random weights (an :class:`lm.LM` or :class:`encdec.EncDec`) drawn
    on ``device`` from a ``torch.Generator`` seeded with ``seed``."""
    generator = torch.Generator(device=resolve_device(device))
    generator.manual_seed(seed)
    if is_encdec(cfg):
        return encdec.EncDec(cfg, generator, dtype=param_dtype)
    return lm.LM(cfg, generator, dtype=param_dtype)


def _forward(cfg: ModelConfig, rcfg: RunConfig, model, batch, mode: str):
    if is_encdec(cfg):
        return encdec.forward(cfg, rcfg, model, batch["tokens"],
                              batch["frames"], mode=mode)
    return lm.forward(cfg, rcfg, model, batch["tokens"],
                      extra_embeds=batch.get("patch_embeds"), mode=mode)


@torch.no_grad()
def prefill(cfg: ModelConfig, rcfg: RunConfig, model, batch):
    """batch: ``{"tokens": [B, S]}``, plus ``"frames"`` [B, Se, d] for
    whisper or ``"patch_embeds"`` [B, F, d] for the vlm prefix.  Returns
    (last logits [B, 1, V], cache)."""
    logits, cache, _ = _forward(cfg, rcfg, model, batch, mode="prefill")
    return logits[:, -1:], cache


def init_cache(cfg: ModelConfig, rcfg: RunConfig, batch: int, max_len: int,
               *, device="cuda"):
    device = resolve_device(device)
    if is_encdec(cfg):
        return encdec.init_cache(cfg, rcfg, batch, max_len, device=device)
    return lm.init_cache(cfg, rcfg, batch, max_len, device=device)


@torch.no_grad()
def decode_step(cfg: ModelConfig, rcfg: RunConfig, model, cache, token,
                pos: int):
    if is_encdec(cfg):
        return encdec.decode_step(cfg, rcfg, model, cache, token, pos)
    return lm.decode_step(cfg, rcfg, model, cache, token, pos)
