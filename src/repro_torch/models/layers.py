"""Shared building blocks of the LM stack: the weight init, RMSNorm, RoPE,
the MLP, the token embedding and the LM head.  Port of
``repro.models.layers``; weights keep the reference's layout (``[in,
out]``, applied as ``x @ w``), so a reference parameter carries over as it
is.

Numerics follow the reference: norms and RoPE angles in f32, the
embedding scale and the softcaps in the compute dtype, and the non-gated
MLP's GELU in its tanh form (``jax.nn.gelu``'s default, not torch's).

On a mesh (:func:`repro_torch.runtime.sharding.gather_on_use`) the MLP,
the lookup and the head compute on this rank's ``"model"`` shard of the
MLP width or the vocab where the rules split it
(:func:`~repro_torch.runtime.sharding.model_shard`), and whole where they
left it replicated.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import sharding as shd


def gen_device(generator: torch.Generator | None) -> torch.device:
    """The device weights are drawn on: the generator's, or ``meta`` (shapes
    and dtypes only, no storage) when ``generator`` is None."""
    return torch.device("meta") if generator is None else generator.device


def dense_init(shape, generator: torch.Generator | None, *, scale=None,
               dtype=torch.float32) -> nn.Parameter:
    """Normal weights scaled by ``fan_in ** -0.5`` (or ``scale``), drawn
    on the generator's device.  ``fan_in`` is ``shape[0]``, as in the
    reference (for expert weights [E, d, ff] that is E)."""
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = fan_in ** -0.5 if scale is None else scale
    w = torch.randn(shape, generator=generator,
                    device=gen_device(generator), dtype=torch.float32) * scale
    return nn.Parameter(w.to(dtype))


def ones(n: int, generator: torch.Generator | None, dtype) -> nn.Parameter:
    """A norm weight of ones on the generator's device."""
    return nn.Parameter(torch.ones(n, device=gen_device(generator),
                                   dtype=dtype))


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``like``'s dtype, as ``jnp.asarray(value,
    dtype)`` rounds it (in bf16, sqrt(4608) becomes 68.0).  A fill on the
    device: a copy from the host would wait for the card's queue."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x, w, eps: float = 1e-6, *, zero_centered: bool = False):
    """RMSNorm computed in f32, returned in ``x.dtype``; ``zero_centered``
    (gemma) scales by ``1 + w``."""
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    w = w.float()
    if zero_centered:
        w = 1.0 + w
    return (y * w).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions broadcastable to [..., S].  The
    half-split rotation (``x[:D/2]`` with ``x[D/2:]``), angles in f32."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq           # [..., S, half]
    angles = angles[..., None, :]                          # [..., S, 1, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU or plain GELU)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """``wi_gate`` [d, ff] (gated only), ``wi`` [d, ff], ``wo`` [ff, d]."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 d_ff: int | None = None, *, dtype=torch.float32):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        d = cfg.d_model
        if cfg.mlp_gated:
            self.wi_gate = dense_init((d, d_ff), generator, dtype=dtype)
        self.wi = dense_init((d, d_ff), generator, dtype=dtype)
        self.wo = dense_init((d_ff, d), generator, dtype=dtype)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(cfg: ModelConfig, p: MLP, x, sp=None):
    """``wi``/``wi_gate`` column-parallel and ``wo`` row-parallel over the
    ``"mlp"`` shard, where the rules split it.  Under sequence parallelism
    (``sp``, this rank's positions of ``x``) a split MLP reads the whole
    sequence (:func:`~repro_torch.runtime.sharding.gather_seq`) and leaves
    its partial sums on each rank's positions (``scatter_seq``); a whole
    one computes on the local positions."""
    sh = shd.model_shard(p, "wi")
    leaves = ("wi_gate", "wi", "wo") if cfg.mlp_gated else ("wi", "wo")
    if sp is not None and sh is None:
        w = {k: shd.copy_to_model(getattr(p, k), sp) for k in leaves}
        enter, leave = (lambda t: t), (lambda t: t)
    elif sp is not None:
        w = {k: getattr(p, k) for k in leaves}
        enter = functools.partial(shd.gather_seq, shard=sp)
        leave = functools.partial(shd.scatter_seq, shard=sp)
    else:
        w = {k: getattr(p, k) for k in leaves}
        enter = functools.partial(shd.copy_to_model, shard=sh)
        leave = functools.partial(shd.reduce_from_model, shard=sh)
    x = enter(x)
    h = x @ w["wi"].to(x.dtype)
    if cfg.mlp_gated:
        g = x @ w["wi_gate"].to(x.dtype)
        h = F.silu(g) * h
    else:
        h = gelu(h)
    return leave(h @ w["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


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


def embed_tokens(cfg: ModelConfig, p: Embedding, tokens, compute_dtype, *,
                 partial: bool = False):
    """tokens [B, S] -> [B, S, d] in ``compute_dtype``.  Gathers, then
    casts: the same values as the reference's cast of the whole table.
    ``scale_embeddings`` multiplies by ``d_model ** 0.5`` rounded to the
    compute dtype first.  On a vocab shard, each rank looks up the tokens
    in its range and the rows are summed over the group (one is not
    zero); with ``partial`` they are returned unsummed (zero rows for the
    tokens of other ranks, scaled all the same: a sum of one row and
    zeros is exact, so the scale may come first), for the caller to sum
    onto its positions."""
    sh = embed_shard(p)
    tokens = tokens.long()
    if sh is None:
        x = p.embedding[tokens].to(compute_dtype)
    else:
        local = tokens - sh.start
        mine = (local >= 0) & (local < sh.stop - sh.start)
        x = p.embedding[torch.where(mine, local, 0)].to(compute_dtype)
        x = torch.where(mine[..., None], x, 0)
        if not partial:
            x = shd.reduce_from_model(x, sh)
    if cfg.scale_embeddings:
        x = x * scalar(cfg.d_model ** 0.5, x)
    return x


def embed_shard(p: Embedding) -> shd.ModelShard | None:
    """The vocab shard of the token table."""
    return shd.model_shard(p, "embedding")


def add_positions(cfg: ModelConfig, p: Embedding, x, positions, sp=None):
    """Adds learned position embeddings; RoPE is applied in attention.
    Under sequence parallelism ``x`` holds this rank's positions ``sp`` of
    the whole sequence's ``positions`` (the same in every row): the
    table's rows of the whole sequence, read alike on every rank, are
    split (their gradient all-gathered, not the table's all-reduced)."""
    if cfg.pos_embedding == "learned":
        if sp is None:
            x = x + p.pos_embedding[positions.long()].to(x.dtype)
        else:
            rows = p.pos_embedding[positions[0].long()][None]
            x = x + shd.split_seq(rows, sp).to(x.dtype)
    return x


def softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap else x


def head_shard(cfg: ModelConfig, p: Embedding) -> shd.ModelShard | None:
    """The vocab shard of the LM head (the table where it is tied)."""
    return shd.model_shard(p, "embedding" if cfg.tie_embeddings
                           else "lm_head")


def lm_logits(cfg: ModelConfig, p: Embedding, x, sp=None):
    """x [B, S, d] -> logits [B, S, V]: the final-logit softcap, then the
    padded vocab entries set to -1e30.  On a vocab shard, this rank's
    logits [B, S, V/n] of the entries ``head_shard(cfg, p)`` holds.  Under
    sequence parallelism ``x`` holds this rank's positions ``sp`` and the
    sequence is gathered whole first."""
    sh = head_shard(cfg, p)
    if sp is not None:     # the whole sequence; a split head's gradient of
        x = (shd.gather_seq(x, sp) if sh is not None   # it is partial
             else shd.gather_from_model(x, sp))
    x = shd.copy_to_model(x, sh if sp is None else None)
    if cfg.tie_embeddings:
        logits = x @ p.embedding.to(x.dtype).T
    else:
        logits = x @ p.lm_head.to(x.dtype)
    logits = softcap(logits, cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        lo = 0 if sh is None else sh.start
        pad_mask = torch.arange(lo, lo + logits.shape[-1],
                                device=x.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    return logits
