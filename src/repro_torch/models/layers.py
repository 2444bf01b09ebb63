"""Shared building blocks of the LM stack: the weight init, RMSNorm, the
token embedding and the LM head.  Port of ``repro.models.layers``; weights
keep the reference's layout (``[in, out]``, applied as ``x @ w``), so a
reference parameter carries over as it is.

RoPE and the MLP, and the gemma-style options (embedding scale, final
logit softcap, zero-centred norms), wait for the dense family (ROADMAP
Queue 1 item 9) and raise :class:`NotImplementedError` until then.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item 9)")


def dense_init(shape, generator: torch.Generator, *, scale=None,
               dtype=torch.float32) -> nn.Parameter:
    """Normal weights scaled by ``fan_in ** -0.5`` (or ``scale``), drawn
    on the generator's device."""
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = fan_in ** -0.5 if scale is None else scale
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32) * scale
    return nn.Parameter(w.to(dtype))


def rmsnorm(x, w, eps: float = 1e-6):
    """RMSNorm computed in f32, returned in ``x.dtype``."""
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(dt)


class Embedding(nn.Module):
    """The token table ``embedding`` [V, d] (V the padded vocab), the LM head
    ``lm_head`` [d, V] unless it is tied to the table, and a learned
    position table ``pos_embedding`` where the config asks for one."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, *,
                 dtype=torch.float32):
        super().__init__()
        v, d = cfg.padded_vocab, cfg.d_model
        self.embedding = dense_init((v, d), generator, scale=1.0, dtype=dtype)
        if not cfg.tie_embeddings:
            self.lm_head = dense_init((d, v), generator, dtype=dtype)
        if cfg.pos_embedding == "learned":
            n_pos = cfg.max_position or max(cfg.encoder_seq, 8192)
            self.pos_embedding = dense_init((n_pos, d), generator,
                                            scale=0.02, dtype=dtype)


def embed_tokens(cfg: ModelConfig, p: Embedding, tokens, compute_dtype):
    """tokens [B, S] -> [B, S, d] in ``compute_dtype``.  Gathers, then
    casts: the same values as the reference's cast of the whole table."""
    if cfg.scale_embeddings:
        raise not_ported("the embedding scale (gemma2)")
    return p.embedding[tokens.long()].to(compute_dtype)


def add_positions(cfg: ModelConfig, p: Embedding, x, positions):
    """Adds learned position embeddings; RoPE is applied in attention."""
    if cfg.pos_embedding == "learned":
        x = x + p.pos_embedding.to(x.dtype)[positions.long()]
    return x


def lm_logits(cfg: ModelConfig, p: Embedding, x):
    """x [B, S, d] -> logits [B, S, V]; the padded vocab entries are
    -1e30."""
    if cfg.logit_softcap:
        raise not_ported("the final-logit softcap (gemma2)")
    if cfg.tie_embeddings:
        logits = x @ p.embedding.to(x.dtype).T
    else:
        logits = x @ p.lm_head.to(x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab,
                                device=x.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    return logits
