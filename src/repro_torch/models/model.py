"""Model API: init, loss, prefill, decode across every family.  Port of
``repro.models.model``: the encoder-decoder family (whisper) goes to
:mod:`repro_torch.models.encdec`, every other one to
:mod:`repro_torch.models.lm`.  ``loss_fn`` runs under autograd; prefill and
decode run without it.

``input_specs``, ``cache_specs`` and ``param_specs`` are the dry-run
contract: ``device="meta"`` tensors of the reference's shapes and dtypes
(no storage; the whole cache, which the rules' layout splits on a mesh:
:func:`place_cache`, :func:`init_cache` with a bound model).
``param_specs`` is the port's state dict, one entry per layer where the
reference stacks a pattern position over its blocks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import attention as attn
from repro_torch.models import encdec, lm
from repro_torch.models import layers as L
from repro_torch.models.ssm import conv_from_layout
from repro_torch.runtime import sharding as shd


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


def _log_likelihood(logits, labels, sh):
    """The f32 log-probability of each label.  On a vocab shard ``sh``
    (logits [B, S, V/n]) it is the vocab-parallel form: the max and the sum
    of exponentials over the group, the label's logit from the rank that
    holds it; ``[B, S, V]`` is never gathered."""
    logits = logits.float()
    if sh is None:
        return torch.log_softmax(logits, dim=-1).gather(
            -1, labels[..., None])[..., 0]
    m = shd.max_over_model(logits.amax(-1, keepdim=True), sh)
    sumexp = shd.reduce_from_model(torch.exp(logits - m).sum(-1), sh)
    local = labels - sh.start
    mine = (local >= 0) & (local < logits.shape[-1])
    own = logits.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0]
    own = shd.reduce_from_model(torch.where(mine, own, 0.0), sh)
    return own - m[..., 0] - torch.log(sumexp)


def loss_fn(cfg: ModelConfig, rcfg: RunConfig, model, batch):
    """Next-token cross entropy (labels < 0 are ignored; the vlm prefix is
    padded with -1 labels) on f32 log-probabilities, plus
    ``router_aux_weight · moe_aux / num_layers``.  Returns (loss, metrics
    with ``"ce"``), all on the device; on a mesh every rank of a
    ``"model"`` group computes the same loss."""
    logits, _, metrics = _forward(cfg, rcfg, model, batch, mode="train")
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:   # vlm prefix: pad with -1
        labels = F.pad(labels, (logits.shape[1] - labels.shape[1], 0),
                       value=-1)
    valid = labels >= 0
    labels_c = labels.clamp(0, cfg.padded_vocab - 1).long()
    ll = _log_likelihood(logits, labels_c, L.head_shard(cfg, model.embed))
    denom = valid.sum().clamp_min(1)
    ce = -torch.where(valid, ll, 0.0).sum() / denom
    total = ce + cfg.router_aux_weight * metrics["moe_aux"] / max(
        cfg.num_layers, 1)
    metrics = dict(metrics)
    metrics["ce"] = ce
    return total, metrics


def whole_logits(cfg: ModelConfig, model, logits):
    """Logits [B, 1, V]: a vocab shard's [B, 1, V/n] gathered over the
    group (the server samples from the whole row)."""
    return shd.gather_from_model(logits, L.head_shard(cfg, model.embed),
                                 dim=-1)


@torch.no_grad()
def prefill(cfg: ModelConfig, rcfg: RunConfig, model, batch,
            max_len: int | None = None):
    """batch: ``{"tokens": [B, S]}``, plus ``"frames"`` [B, Se, d] for
    whisper or ``"patch_embeds"`` [B, F, d] for the vlm prefix.  Returns
    (last logits [B, 1, V], cache).  Without ``max_len`` the cache is the
    layers' own: on a mesh this rank's kv and SSM heads (every position;
    every kv head under sequence parallelism).  With ``max_len``, the
    decode capacity, it is :func:`place_cache`'s."""
    logits, cache, _ = _forward(cfg, rcfg, model, batch, mode="prefill")
    if max_len is not None:
        cache = place_cache(cfg, model, cache, max_len)
    return whole_logits(cfg, model, logits[:, -1:]), cache


def _cache_modules(cfg: ModelConfig, model):
    """``{leaf: module}`` per cache entry: the attention or Mamba2 mixer
    whose weights' shards give a cache leaf's layout (every layer of a
    pattern position, or of whisper's decoder, shares it)."""
    if is_encdec(cfg):
        d = model.decoder[0]
        return {"k": d.mixer, "v": d.mixer, "cross_k": d.cross,
                "cross_v": d.cross}
    return [{k: model.layers[i].mixer for k in ("k", "v", "conv")}
            for i in range(len(cfg.full_pattern))]


def place_cache(cfg: ModelConfig, model, cache, max_len: int):
    """A prefill's cache grown to the decode capacity ``max_len``
    (:func:`repro_torch.serve.serve_step.pad_cache`) and, on a mesh, each
    leaf this rank's piece in the rules' layout, which the decode reads:
    the ring ``cache_seq`` split over ``"model"`` where it divides (each
    rank W/n slots of every kv head), else the kv heads where they
    divide, else whole; the conv state split on its channels, the SSM
    state on its heads.  The layers' own layout (local kv heads at every
    position, or every kv head) is made whole once, then padded, then
    cut: which slots a rank owns depends on the padded W."""
    from repro_torch.serve.serve_step import pad_cache
    group = shd.model_group(model.embed)
    if group is None:
        return pad_cache(cfg, cache, max_len)
    mods = _cache_modules(cfg, model)

    def whole(entry, mod):
        out = dict(entry)
        for k, x in entry.items():
            if k in ("k", "v", "cross_k", "cross_v") and \
                    x.shape[-2] < cfg.num_kv_heads:
                out[k] = shd.gather_from_model(
                    x, attn.heads_shards(mod[k])[1], dim=-2)
        return out

    def cut(entry, mod):
        out = dict(entry)
        for k, x in entry.items():
            if k == "conv":
                sh = shd.model_shard(mod[k], "A_log")
                out[k] = conv_from_layout(cfg, mod[k], x, sh)
            elif k in ("k", "v", "cross_k", "cross_v"):
                piece = shd.model_piece(shd.resolve_axes(k, x.dim()),
                                        x.shape, group)
                if piece is not None:
                    out[k] = x.narrow(piece[0], piece[1],
                                      piece[2] - piece[1])
        return out

    if is_encdec(cfg):
        return cut(pad_cache(cfg, whole(cache, mods), max_len), mods)
    grown = pad_cache(cfg, [whole(e, m) for e, m in zip(cache, mods)],
                      max_len)
    return [cut(e, m) for e, m in zip(grown, mods)]


def init_cache(cfg: ModelConfig, rcfg: RunConfig, batch: int, max_len: int,
               *, device="cuda", model=None):
    """A zero cache (every ``pos`` -1) for ``batch`` rows and capacity
    ``max_len``; with ``model`` bound on a mesh, each leaf this rank's
    piece of it in the rules' layout (:func:`place_cache`'s)."""
    device = resolve_device(device)
    if is_encdec(cfg):
        cache = encdec.init_cache(cfg, rcfg, batch, max_len, device=device)
    else:
        cache = lm.init_cache(cfg, rcfg, batch, max_len, device=device)
    group = None if model is None else shd.model_group(model.embed)
    if group is None:
        return cache

    def piece(path, x):
        cut = shd.model_piece(shd.resolve_axes(path, x.dim()), x.shape,
                              group)
        if cut is None:
            return x
        return x.narrow(cut[0], cut[1], cut[2] - cut[1]).clone()
    return shd.tree_map_with_path(piece, cache)


@torch.no_grad()
def decode_step(cfg: ModelConfig, rcfg: RunConfig, model, cache, token,
                pos: int):
    """token: [B, 1] at ``pos``.  Returns (logits [B, 1, V], the new
    cache)."""
    step = encdec.decode_step if is_encdec(cfg) else lm.decode_step
    logits, cache = step(cfg, rcfg, model, cache, token, pos)
    return whole_logits(cfg, model, logits), cache


# ---------------------------------------------------------------------------
# input_specs — the dry-run contract
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                compute_dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Meta tensors for every model input of this (arch, shape) cell.

    train/prefill: {"tokens", "labels"?, frontend stubs}
    decode:        {"token", "pos"} (the cache comes from cache_specs())."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def spec(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind == "decode":
        return {"token": spec((b, 1), i32), "pos": spec((), i32)}
    batch: dict[str, torch.Tensor] = {}
    if is_encdec(cfg):
        batch["frames"] = spec((b, cfg.encoder_seq, cfg.d_model),
                               compute_dtype)
        batch["tokens"] = spec((b, s), i32)
    elif cfg.frontend == "patch":
        f = cfg.frontend_seq
        batch["patch_embeds"] = spec((b, f, cfg.d_model), compute_dtype)
        batch["tokens"] = spec((b, s - f), i32)
    else:
        batch["tokens"] = spec((b, s), i32)
    if shape.kind == "train":
        batch["labels"] = spec((b, s), i32)
    return batch


def cache_specs(cfg: ModelConfig, rcfg: RunConfig, shape: ShapeConfig):
    """The KV/SSM cache of a decode cell, as meta tensors."""
    return init_cache(cfg, rcfg, shape.global_batch, shape.seq_len,
                      device="meta")


def skeleton(cfg: ModelConfig, param_dtype=torch.float32):
    """The model's modules with ``meta`` parameters: shapes and dtypes,
    nothing allocated, at any size."""
    return (encdec.EncDec(cfg, None, dtype=param_dtype) if is_encdec(cfg)
            else lm.LM(cfg, None, dtype=param_dtype))


def param_specs(cfg: ModelConfig,
                param_dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The model's state dict as meta tensors."""
    return skeleton(cfg, param_dtype).state_dict()
