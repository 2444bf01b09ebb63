"""Serving: prefill, pad the cache, then batched greedy or temperature
decode.  Port of ``repro.serve.serve_step``.

Greedy decoding is the reference's token for token (the same argmax on
the same logits); temperature sampling draws from a ``torch.Generator``
and cannot reproduce ``jax.random``'s draws.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model as M


def _pad_entry(e, tgt: int):
    w = e["k"].shape[-3]
    if w >= tgt:
        return e
    padw = tgt - w
    out = dict(e)
    for key_ in ("k", "v"):
        out[key_] = F.pad(e[key_], (0, 0, 0, 0, 0, padw))
    out["pos"] = F.pad(e["pos"], (0, padw), value=-1)
    return out


def pad_cache(cfg: ModelConfig, cache, target_len: int):
    """Grow prefill caches to decode capacity.  Global-attention entries pad
    their seq dim to ``target_len``; sliding-window entries to the ring size
    min(window, target); SSM states are fixed-size and pass through.  Ring
    arithmetic stays valid because prefill slots satisfy slot = pos % W
    for every W >= S.  The enc-dec cache (one dict) pads its self-attention
    K/V; its cross K/V are fixed-size."""
    if not isinstance(cache, list):
        return _pad_entry(cache, target_len)
    out = []
    for spec, e in zip(cfg.full_pattern, cache):
        if spec.mixer == "attn_local" and cfg.sliding_window:
            out.append(_pad_entry(e, min(cfg.sliding_window, target_len)))
        elif spec.mixer == "attn":
            out.append(_pad_entry(e, target_len))
        else:
            out.append(e)
    return out


def sample(logits, generator=None, temperature: float = 0.0):
    """logits: [B, 1, V] -> tokens [B, 1] int32: the argmax, or with
    ``temperature > 0`` a draw from softmax(logits / temperature)."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    tok = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                            generator=generator)
    return tok.reshape(logits.shape[:-1]).to(torch.int32)


@torch.no_grad()
def generate(cfg: ModelConfig, rcfg: RunConfig, model, batch, *,
             max_new_tokens: int, temperature: float = 0.0, seed: int = 0,
             device="cuda"):
    """Prefill the prompt batch ``{"tokens": [B, S]}`` (plus ``"frames"``
    for whisper or ``"patch_embeds"`` for the vlm prefix), then decode
    ``max_new_tokens`` tokens.  ``model`` lies on ``device``; on a mesh
    (sharded serving) the cache is grown and placed in the rules' layout
    at the end of the prefill (:func:`repro_torch.models.model.
    place_cache`) and the decode reads it there.  Returns tokens [B,
    max_new_tokens] int32."""
    dev = resolve_device(device)
    model_dev = model.embed.embedding.device
    if model_dev.type != dev.type:
        raise ValueError(f"model on {model_dev}, generate asked for {dev}")
    batch = {k: torch.as_tensor(v, device=model_dev)
             for k, v in batch.items()}
    prompt_len = batch["tokens"].shape[1]
    if cfg.frontend == "patch":
        prompt_len += cfg.frontend_seq
    logits, cache = M.prefill(cfg, rcfg, model, batch,
                              max_len=prompt_len + max_new_tokens)
    generator = torch.Generator(device=model_dev).manual_seed(seed)
    tok = sample(logits, generator, temperature)
    toks = [tok]
    for i in range(max_new_tokens - 1):
        logits, cache = M.decode_step(cfg, rcfg, model, cache, tok,
                                      prompt_len + i)
        tok = sample(logits, generator, temperature)
        toks.append(tok)
    return torch.cat(toks, dim=1)
