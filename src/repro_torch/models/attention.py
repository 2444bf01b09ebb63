"""Attention: GQA with RoPE, local/global windows, softcaps, KV caches.

Port of ``repro.models.attention``.  Two numerically equivalent paths,
held against each other by the tests as the reference's are:

* ``direct``  — one [Sq, Sk] logits tensor; short sequences and decode
  (Sq == 1).
* ``chunked`` — flash-style attention in plain torch: q in chunks, an
  online softmax over kv chunks.  Bounded memory for long prefills.  With
  ``causal_skip`` each q chunk scans only its causal prefix of kv chunks.

K/V are stored grouped ([B, S, KV, D]) and repeated to the full head
count at use (``repeat_kv``: each kv head serves H/KV consecutive q
heads).  Numerics follow the reference: logits and the softmax in f32,
the softcap before the mask, ``NEG_INF = -1e30`` with a guard for fully
masked rows, probabilities cast to ``v``'s dtype before P·V.  The
reference has no Pallas kernel here, so neither path is a hand-written
kernel: they are ``torch.matmul``.

On a mesh the layer computes on this rank's ``"model"`` shard of the
heads where the rules split them: the projections are column-parallel,
``wo`` row-parallel, and each local q head reads its own kv head, from
the local kv heads where those are split too, else from the whole set
that every rank computes.  Where the fallback replicated the heads, the
layer computes them whole.  Under sequence parallelism it computes every
head of this rank's positions against the whole sequence's K/V
(:func:`attn_apply`), and a decode cache split on its ring
(``cache_seq``) is attended a part a rank (:func:`attn_decode`).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import sharding as shd
from repro_torch.models.layers import (dense_init, gen_device, ones, rmsnorm,
                                      rope, scalar)

NEG_INF = -1e30


class Attention(nn.Module):
    """``wq`` [d, H, hd], ``wk``/``wv`` [d, KV, hd], ``wo`` [H, hd, d];
    ``bq`` [H, hd], ``bk``/``bv`` [KV, hd] with ``qkv_bias`` (zeros);
    ``q_norm``/``k_norm`` [hd] with ``qk_norm``."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, *,
                 dtype=torch.float32):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        dev = gen_device(generator)
        self.wq = dense_init((d, h, hd), generator, dtype=dtype)
        self.wk = dense_init((d, kv, hd), generator, dtype=dtype)
        self.wv = dense_init((d, kv, hd), generator, dtype=dtype)
        self.wo = dense_init((h, hd, d), generator, dtype=dtype)
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(h, hd, device=dev, dtype=dtype))
            self.bk = nn.Parameter(torch.zeros(kv, hd, device=dev,
                                               dtype=dtype))
            self.bv = nn.Parameter(torch.zeros(kv, hd, device=dev,
                                               dtype=dtype))
        if cfg.qk_norm:
            self.q_norm = ones(hd, generator, dtype)
            self.k_norm = ones(hd, generator, dtype)


def heads_shards(p: Attention):
    """(the q heads' ``"model"`` shard, the kv heads') of the layer's
    weights; None where whole."""
    return shd.model_shard(p, "wq"), shd.model_shard(p, "wk")


def _inputs(p: Attention, x):
    """(x for the q projection, x for the k/v projections): ``x`` enters
    the sharded heads once, and the kv projections computed whole read it
    as it is."""
    qs, ks = heads_shards(p)
    xq = shd.copy_to_model(x, qs)
    return xq, (xq if ks is not None else x)


def _proj(x, w):
    """x [B, S, d] @ w [d, H, D] -> [B, S, H, D] in x's dtype."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _read(p: Attention, leaf: str, sp):
    """The weight ``leaf`` as the layer reads it: its bound piece, or under
    sequence parallelism (``sp``) whole, every head: gathered over its
    ``"model"`` shard (its gradient, a partial sum over this rank's
    positions, reduce-scattered back) or, left whole by the fallback,
    copied in (its gradient all-reduced)."""
    w = getattr(p, leaf)
    if sp is None:
        return w
    sh = shd.model_shard(p, leaf)
    return shd.gather_seq(w, sh) if sh is not None else \
        shd.copy_to_model(w, sp)


def _norm_in(p: Attention, leaf: str, sp):
    """``q_norm``/``k_norm``: whole, its gradient summed over the group of
    the heads it scales (or of the positions under ``sp``)."""
    sh = sp if sp is not None else heads_shards(p)[leaf == "k_norm"]
    return shd.copy_to_model(getattr(p, leaf), sh)


def project_q(cfg: ModelConfig, p: Attention, x, positions, *,
              use_rope: bool = True, sp=None):
    """The layer's (local) q heads from ``x``, the first of
    :func:`_inputs`; ``q_norm`` is whole and its gradient summed over the
    heads' group.  Under sequence parallelism (``sp``) every head, of this
    rank's positions."""
    q = _proj(x, _read(p, "wq", sp))
    if cfg.qkv_bias:
        q = q + _read(p, "bq", sp).to(x.dtype)
    if cfg.qk_norm:
        q = rmsnorm(q, _norm_in(p, "q_norm", sp), cfg.norm_eps)
    if use_rope and cfg.pos_embedding == "rope":
        q = rope(q, positions, cfg.rope_theta)
    return q


def project_kv(cfg: ModelConfig, p: Attention, x, positions, *,
               use_rope: bool = True, sp=None):
    """The layer's (local) kv heads from ``x``, the second of
    :func:`_inputs`; every kv head under ``sp``."""
    k = _proj(x, _read(p, "wk", sp))
    v = _proj(x, _read(p, "wv", sp))
    if cfg.qkv_bias:
        k = k + _read(p, "bk", sp).to(x.dtype)
        v = v + _read(p, "bv", sp).to(x.dtype)
    if cfg.qk_norm:
        k = rmsnorm(k, _norm_in(p, "k_norm", sp), cfg.norm_eps)
    if use_rope and cfg.pos_embedding == "rope":
        k = rope(k, positions, cfg.rope_theta)
    return k, v


def repeat_kv(x, num_heads: int):
    """[B, S, KV, D] -> [B, S, H, D]: each kv head repeated H/KV times in
    place (``jnp.repeat``, not a tile)."""
    reps = num_heads // x.shape[2]
    return x if reps == 1 else x.repeat_interleave(reps, dim=2)


def kv_for_heads(cfg: ModelConfig, p: Attention, k, v):
    """K/V [B, S, KV', D] of the layer's kv heads -> [B, S, H', D], one per
    local q head: with both head dims split each rank's q heads read its
    own kv heads (:func:`repeat_kv`); with the kv heads whole and the q
    heads split, the kv heads of the local q heads, which enter the
    sharded heads here; with both whole, :func:`repeat_kv`."""
    qs, ks = heads_shards(p)
    if qs is None or ks is not None:
        h = cfg.num_heads if qs is None else qs.stop - qs.start
        return repeat_kv(k, h), repeat_kv(v, h)
    reps = cfg.num_heads // cfg.num_kv_heads
    idx = torch.arange(qs.start, qs.stop, device=k.device) // reps
    return (shd.copy_to_model(k, qs).index_select(2, idx),
            shd.copy_to_model(v, qs).index_select(2, idx))


def _mask(q_pos, k_pos, *, causal: bool, window: int | None):
    """q_pos [B, Sq], k_pos [B, Sk] -> bool [B, 1, Sq, Sk]; key slots with
    pos < 0 (empty ring slots) are invalid."""
    qp = q_pos[:, None, :, None]
    kp = k_pos[:, None, None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (kp > qp - window)
    return m


def _logits(q, k, softcap_val):
    """q [B, Sq, H, D], k [B, Sk, H, D] -> f32 [B, H, Sq, Sk]: products of
    the inputs summed in f32 (the reference's
    ``preferred_element_type=f32``), then the softcap."""
    logits = q.float().transpose(1, 2) @ k.float().permute(0, 2, 3, 1)
    if softcap_val:
        logits = torch.tanh(logits / softcap_val) * softcap_val
    return logits


def _direct(q, k, v, q_pos, k_pos, *, causal, window, softcap_val):
    # q: [B, Sq, H, D] (already scaled); k, v: [B, Sk, H, D]
    logits = _logits(q, k, softcap_val)
    mask = _mask(q_pos, k_pos, causal=causal, window=window)
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True).clamp_min(NEG_INF)  # fully masked rows
    w = torch.exp(logits - m)
    l = w.sum(-1, keepdim=True)
    w = w / l.clamp_min(1e-30)
    return (w.to(v.dtype) @ v.transpose(1, 2)).transpose(1, 2)


def _chunk_step(q, q_pos, k_c, v_c, kpos_c, carry, *, causal, window,
                softcap_val):
    """Online softmax over one kv chunk: carry (m, l, acc) f32 [B, H, Cq],
    [B, H, Cq], [B, H, Cq, D]."""
    m_prev, l_prev, acc = carry
    logits = _logits(q, k_c, softcap_val)
    mask = _mask(q_pos, kpos_c, causal=causal, window=window)
    logits = torch.where(mask, logits, NEG_INF)
    m_cur = torch.maximum(m_prev, logits.amax(-1))
    alpha = torch.exp(m_prev - m_cur)
    w = torch.exp(logits - m_cur[..., None])
    l_cur = l_prev * alpha + w.sum(-1)
    pv = w.to(v_c.dtype) @ v_c.transpose(1, 2)            # [B, H, Cq, D]
    acc = acc * alpha[..., None] + pv.float()
    return m_cur, l_cur, acc


def _chunked(q, k, v, q_pos, k_pos, *, causal, window, softcap_val,
             chunk_q, chunk_k, causal_skip):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    cq, ck = min(chunk_q, sq), min(chunk_k, sk)
    nq, nk = sq // cq, sk // ck
    if sq % cq or sk % ck:
        raise ValueError(f"chunks {cq}/{ck} do not divide {sq}/{sk}")
    skip = causal_skip and causal and window is None

    outs = []
    for i in range(nq):
        q_c, qpos_c = q[:, i * cq:(i + 1) * cq], q_pos[:, i * cq:(i + 1) * cq]
        # with causal_skip, chunk i attends to kv chunks [0, last_k]
        n_kv = ((i + 1) * cq - 1) // ck + 1 if skip else nk
        carry = (q.new_full((b, h, cq), NEG_INF, dtype=torch.float32),
                 q.new_zeros((b, h, cq), dtype=torch.float32),
                 q.new_zeros((b, h, cq, d), dtype=torch.float32))
        for j in range(n_kv):
            sl = slice(j * ck, (j + 1) * ck)
            carry = _chunk_step(q_c, qpos_c, k[:, sl], v[:, sl],
                                k_pos[:, sl], carry, causal=causal,
                                window=window, softcap_val=softcap_val)
        _, l, acc = carry
        out = acc / l.clamp_min(1e-30)[..., None]
        outs.append(out.transpose(1, 2))                   # [B, Cq, H, D]
    return torch.cat(outs, dim=1).to(v.dtype)


def attention_core(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                   softcap_val=None, chunk=2048, causal_skip=False,
                   force_direct=False, kv_chunk_only=False):
    """q: [B, Sq, H, D]; k, v: [B, Sk, H, D] (kv already repeated to H).

    q_pos/k_pos: int [B, Sq] / [B, Sk]; k slots with pos < 0 are invalid.
    The direct path for decode, ``force_direct`` or Sk <= ``chunk``, else
    the chunked one (``kv_chunk_only`` keeps q whole)."""
    d = q.shape[-1]
    q = q * scalar(d ** -0.5, q)
    sq, sk = q.shape[1], k.shape[1]
    if force_direct or sq == 1 or sk <= chunk:
        return _direct(q, k, v, q_pos, k_pos, causal=causal, window=window,
                       softcap_val=softcap_val)
    cq = sq if kv_chunk_only else _largest_divisor_leq(sq, max(chunk // 2, 1))
    ck = _largest_divisor_leq(sk, chunk)
    return _chunked(q, k, v, q_pos, k_pos, causal=causal, window=window,
                    softcap_val=softcap_val, chunk_q=cq, chunk_k=ck,
                    causal_skip=causal_skip and not kv_chunk_only)


def _largest_divisor_leq(n: int, cap: int) -> int:
    for c in range(min(cap, n), 0, -1):
        if n % c == 0:
            return c
    return 1


# ---------------------------------------------------------------------------
# Full attention layer (projections + core + output), with KV cache support.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AttnCall:
    """Static attention-call options resolved from the layer kind."""
    causal: bool = True
    window: int | None = None
    use_rope: bool = True


def _out(p: Attention, o, dtype, sp=None):
    """[B, S, H, D] @ wo [H, D, d] -> [B, S, d], as one [B·S, H·D]
    product: a 3-D left operand with a size-1 dim (decode) would fold to
    a product or not depending on that dim's stride, which fake tensors
    (the dry run) set differently from real ones.  Row-parallel over the
    local heads: their partial sums are summed over the group.  Under
    ``sp`` every head of this rank's positions, ``wo`` read whole."""
    wo = _read(p, "wo", sp)
    h, k, d = wo.shape
    b, s = o.shape[:2]
    y = (o.reshape(b * s, h * k) @ wo.to(dtype).reshape(h * k, d)
         ).reshape(b, s, d)
    return y if sp is not None else shd.reduce_from_model(
        y, heads_shards(p)[0])


def attn_apply(cfg: ModelConfig, p: Attention, x, positions, call: AttnCall,
               *, chunk=None, causal_skip=False, seq_parallel=False,
               sp=None):
    """Training / prefill self-attention (no cache).  Returns (out, (k,
    v)), k and v grouped [B, S, KV, D].  ``seq_parallel`` keeps q whole
    in the chunked path (``kv_chunk_only``), as the reference does.

    ``sp`` (this rank's positions of the sequence, where the rules split
    ``act_seq`` under ``seq_parallel``) runs the reference's layout: ``x``
    holds this rank's positions, ``positions`` the whole sequence's; q
    covers them with every head (the weights read whole), the grouped K/V
    of the local positions are all-gathered to the whole sequence before
    they are repeated, and the core runs the local queries against every
    key with no causal skip.  ``wo`` returns the local positions, and the
    K/V returned are the gathered ones (the prefill's cache)."""
    if sp is not None:
        q_pos = positions[:, sp.start:sp.stop]
        q = project_q(cfg, p, x, q_pos, use_rope=call.use_rope, sp=sp)
        k, v = project_kv(cfg, p, x, q_pos, use_rope=call.use_rope, sp=sp)
        k, v = shd.gather_seq(k, sp), shd.gather_seq(v, sp)
        out = attention_core(
            q, repeat_kv(k, cfg.num_heads), repeat_kv(v, cfg.num_heads),
            q_pos, positions, causal=call.causal, window=call.window,
            softcap_val=cfg.attn_softcap, chunk=chunk or cfg.attn_chunk,
            kv_chunk_only=True)
        return _out(p, out, x.dtype, sp), (k, v)
    xq, xkv = _inputs(p, x)
    q = project_q(cfg, p, xq, positions, use_rope=call.use_rope)
    k, v = project_kv(cfg, p, xkv, positions, use_rope=call.use_rope)
    kf, vf = kv_for_heads(cfg, p, k, v)
    out = attention_core(
        q, kf, vf, positions, positions, causal=call.causal,
        window=call.window, softcap_val=cfg.attn_softcap, chunk=chunk or cfg.attn_chunk,
        causal_skip=causal_skip, kv_chunk_only=seq_parallel)
    return _out(p, out, x.dtype), (k, v)


def softmax_part(q, k, v, q_pos, k_pos, *, causal, window, softcap_val):
    """One part of an attention whose keys are split over ranks: q [B, Sq,
    H, D] (scaled), k/v [B, Sk, H, D] this part's slots.  Returns f32 (m
    [B, H, Sq, 1], l [B, H, Sq, 1], acc [B, H, Sq, D]): the max of the
    part's logits (softcap first, then the mask), the sum of the
    exponentials after it and the values weighted by them.  A part whose
    slots are all masked (empty ring slots, pos < 0) weighs nothing: l
    and acc are 0, whatever its max."""
    logits = _logits(q, k, softcap_val)
    mask = _mask(q_pos, k_pos, causal=causal, window=window)
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True).clamp_min(NEG_INF)
    e = torch.where(mask, torch.exp(logits - m), 0.0)
    return m, e.sum(-1, keepdim=True), e @ v.float().transpose(1, 2)


def merge_parts(m, l, acc, max_over, sum_over):
    """The attention output [B, Sq, H, D] f32 of the parts of
    :func:`softmax_part`: ``max_over``/``sum_over`` take the max and sum of
    a part's tensor over the parts (over the ``"model"`` group on a mesh),
    each part rescaled to the largest max before the sums."""
    scale = torch.exp(m - max_over(m))
    la = sum_over(torch.cat([acc * scale, l * scale], dim=-1))
    return (la[..., :-1] / la[..., -1:].clamp_min(1e-30)).transpose(1, 2)


def _attend_slots(cfg: ModelConfig, p: Attention, q, cache_k, cache_v,
                  q_pos, k_pos, *, causal, window, group, dtype):
    """The local q heads ``q`` [B, Sq, H', D] against this rank's slots of
    a cache split over ``"model"`` on its sequence (``cache_seq``): the
    queries of every head (gathered over the q heads' group), a partial
    softmax over the local slots, the parts combined over ``group``; the
    output of the local heads, [B, Sq, H', D] in ``dtype``."""
    qs = heads_shards(p)[0]
    q = shd.gather_from_model(q, qs, dim=2)
    q = q * scalar(q.shape[-1] ** -0.5, q)
    h = cfg.num_heads
    m, l, acc = softmax_part(q, repeat_kv(cache_k.to(dtype), h),
                             repeat_kv(cache_v.to(dtype), h), q_pos, k_pos,
                             causal=causal, window=window,
                             softcap_val=cfg.attn_softcap)
    sh = shd.ModelShard(1, 0, 0, group)
    out = merge_parts(m, l, acc, lambda t: shd.max_over_model(t, sh),
                      lambda t: shd.reduce_from_model(t, sh)).to(dtype)
    return out if qs is None else out[:, :, qs.start:qs.stop]


def attn_decode(cfg: ModelConfig, p: Attention, x, pos: int, cache_k,
                cache_v, cache_pos, call: AttnCall):
    """Single-token decode.  x: [B, 1, d]; pos: the position (uniform
    over the batch).

    cache_k/v: [B, W', KV', D], on a mesh this rank's piece in the rules'
    layout; cache_pos: [W] int32 (absolute position per slot, -1 = empty,
    whole on every rank); the token goes to ring slot ``pos % W``.  Where
    the rules split the ring over ``"model"`` (``cache_seq``; W' = W/n)
    each rank holds slots ``[r W', (r + 1) W')`` of every kv head, attends
    them for every head and combines its partial softmax with the group's
    (:func:`softmax_part`, :func:`merge_parts`); only the slot's owner
    writes the token's K/V.  Else (W' = W) the rank holds the layer's kv
    heads, local where the rules split them.  Returns (out, new cache_k,
    new cache_v, new cache_pos); the caches passed in are not
    modified."""
    b, w, wl = x.shape[0], cache_pos.shape[0], cache_k.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    xq, xkv = _inputs(p, x)
    q = project_q(cfg, p, xq, positions, use_rope=call.use_rope)
    k, v = project_kv(cfg, p, xkv, positions, use_rope=call.use_rope)
    if wl != w:
        group = shd.model_group(p)
        lo = group[0].get_local_rank(group[1]) * wl
        ks = heads_shards(p)[1]
        k = shd.gather_from_model(k, ks, dim=2)      # every kv head
        v = shd.gather_from_model(v, ks, dim=2)
        slot = pos % w
        cache_pos = cache_pos.clone()
        cache_pos[slot] = pos
        if lo <= slot < lo + wl:
            cache_k, cache_v = cache_k.clone(), cache_v.clone()
            cache_k[:, slot - lo] = k[:, 0].to(cache_k.dtype)
            cache_v[:, slot - lo] = v[:, 0].to(cache_v.dtype)
        k_pos = cache_pos[lo:lo + wl][None, :].expand(b, wl)
        out = _attend_slots(cfg, p, q, cache_k, cache_v, positions, k_pos,
                            causal=call.causal, window=call.window,
                            group=group, dtype=x.dtype)
        return _out(p, out, x.dtype), cache_k, cache_v, cache_pos
    slot = pos % w
    cache_k, cache_v, cache_pos = (cache_k.clone(), cache_v.clone(),
                                   cache_pos.clone())
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    cache_pos[slot] = pos
    kf, vf = kv_for_heads(cfg, p, cache_k.to(x.dtype), cache_v.to(x.dtype))
    k_pos = cache_pos[None, :].expand(b, w)
    out = attention_core(q, kf, vf, positions, k_pos, causal=call.causal,
                         window=call.window, softcap_val=cfg.attn_softcap,
                         force_direct=True)
    return _out(p, out, x.dtype), cache_k, cache_v, cache_pos


def cross_attn_apply(cfg: ModelConfig, p: Attention, x, enc_k, enc_v,
                     sp=None):
    """Encoder-decoder cross attention (whisper).  enc_k/v: [B, Se', KV',
    D] (from :func:`cross_kv`); every encoder slot is valid, no mask, no
    RoPE.  On a mesh: the layer's kv heads, local where the rules split
    them, or (Se' < Se, a decode cache split on ``cache_seq``) this rank's
    slots of every kv head, attended as :func:`attn_decode` attends them.
    Under sequence parallelism (``sp``: ``x`` holds this rank's
    positions) every head, ``enc_k``/``enc_v`` every kv head of the whole
    encoder sequence."""
    b, sq = x.shape[0], x.shape[1]
    positions = torch.zeros((b, sq), dtype=torch.int32, device=x.device)
    se = enc_k.shape[1]
    if sp is not None:
        q = project_q(cfg, p, x, positions, use_rope=False, sp=sp)
        kf = repeat_kv(enc_k.to(x.dtype), cfg.num_heads)
        vf = repeat_kv(enc_v.to(x.dtype), cfg.num_heads)
    else:
        q = project_q(cfg, p, _inputs(p, x)[0], positions, use_rope=False)
    if sp is None and se < cfg.encoder_seq:
        group = shd.model_group(p)
        lo = group[0].get_local_rank(group[1]) * se
        k_pos = torch.arange(lo, lo + se, dtype=torch.int32,
                             device=x.device)[None].expand(b, se)
        out = _attend_slots(cfg, p, q, enc_k, enc_v, positions, k_pos,
                            causal=False, window=None, group=group,
                            dtype=x.dtype)
        return _out(p, out, x.dtype)
    if sp is None:
        kf, vf = kv_for_heads(cfg, p, enc_k.to(x.dtype), enc_v.to(x.dtype))
    k_pos = torch.arange(se, dtype=torch.int32,
                         device=x.device)[None].expand(b, se)
    out = attention_core(q, kf, vf, positions, k_pos, causal=False,
                         window=None, softcap_val=cfg.attn_softcap,
                         force_direct=(sq == 1))
    return _out(p, out, x.dtype, sp)


def cross_kv(cfg: ModelConfig, p: Attention, enc, sp=None):
    """The cross K/V [B, Se, KV', D] of the encoder states ``enc``: the
    layer's kv heads, local where the rules split them; every kv head,
    from the weights read whole, under sequence parallelism (``sp``, the
    decoder's positions: ``enc`` is the whole encoder sequence, entered
    into compute whose gradient is partial)."""
    if sp is not None:
        return project_kv(cfg, p, enc, None, use_rope=False, sp=sp)
    return project_kv(cfg, p, _inputs(p, enc)[1], None, use_rope=False)
