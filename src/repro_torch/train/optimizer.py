"""Optimizers written out in PyTorch: port of ``repro.train.optimizer``.

* AdamW — default for ≤70B-scale configs.
* Adafactor (factored second moment, no first moment) — default for the
  235B/398B configs so optimizer state fits 16 GB/chip HBM.

Parameters, gradients and states are dicts over the model's parameter
names (``dict(model.named_parameters())``); the states hold f32 tensors
on the parameters' devices.  ``update`` works in place — the parameters
and the states are overwritten and returned — so a step needs no second
copy of either.  The arithmetic is the reference's, in its order, in
f32: the bias corrections are ``b ** (step + 1)`` on an f32 tensor.
``torch.optim.AdamW`` is not used: it rounds differently.

The reference stacks each layer's parameters over the blocks of the model
(``blocks[i][name]`` is ``[num_blocks, ...]``) and Adafactor factors the
stacked leaf: over its trailing two dims, so a per-layer vector (a norm)
has its row factor over the layers, and one update clip over the whole
stack.  :func:`stacked_groups` gives those leaves as lists of the port's
names, and Adafactor works on each group stacked, so its arithmetic is
the reference's.  Its state stays per parameter: ``vr``/``vc`` (the
stacked factor's slice; a vector's ``vc`` is shared by its group and
every member holds it) or ``v``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, RunConfig


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable    # params -> opt_state
    update: Callable  # (grads, opt_state, params, step) -> (params, opt_state)


def _step_f32(step, device) -> torch.Tensor:
    """``step + 1`` as an f32 tensor on ``device`` (``step``: an int or a
    0-d tensor).  Made by a fill, not a copy from the host, which would
    wait for the card's queue."""
    if isinstance(step, torch.Tensor):
        return (step.to(device) + 1).to(torch.float32)
    return _f32(step + 1, device)


def _f32(value: float, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def _device(params: dict) -> torch.device:
    return next(iter(params.values())).device


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(rcfg: RunConfig, b1=0.9, b2=0.95, eps=1e-8) -> Optimizer:
    lr, wd = rcfg.learning_rate, rcfg.weight_decay

    def init(params):
        return {s: {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()} for s in ("m", "v")}

    @torch.no_grad()
    def update(grads, state, params, step):
        dev = _device(params)
        step_f = _step_f32(step, dev)
        c1 = 1.0 - _f32(b1, dev) ** step_f
        c2 = 1.0 - _f32(b2, dev) ** step_f
        for k, p in params.items():
            g = grads[k].float()
            m, v = state["m"][k], state["v"][k]
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.mul(1 - b2).mul_(g))
            u = (m / c1).div_((v / c2).sqrt_().add_(eps))
            u.add_(p.float() * wd)
            p.copy_(p.float().sub_(u.mul_(lr)))
        return params, state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018) — factored second moments
# ---------------------------------------------------------------------------


def stacked_groups(cfg: ModelConfig, names) -> list[list[str]]:
    """The reference's parameter leaves as lists of the port's names, in
    stacking order: ``layers.{j * P + i}.x`` over the blocks j for each
    pattern position i (P its length); ``encoder.{l}.x`` and
    ``decoder.{l}.x`` over the layers l; any other name alone."""
    n = len(cfg.full_pattern)
    groups: dict[tuple, list] = {}
    for name in names:
        head, _, rest = name.partition(".")
        if head in ("layers", "encoder", "decoder"):
            idx, _, leaf = rest.partition(".")
            l = int(idx)
            key, order = ((head, l % n, leaf), l // n) if head == "layers" \
                else ((head, leaf), l)
        else:
            key, order = (name,), 0
        groups.setdefault(key, []).append((order, name))
    return [[nm for _, nm in sorted(members)] for members in groups.values()]


def _is_stacked(group: list[str]) -> bool:
    return group[0].split(".", 1)[0] in ("layers", "encoder", "decoder")


def adafactor(rcfg: RunConfig, decay=0.8, eps=1e-30, clip=1.0) -> Optimizer:
    lr, wd = rcfg.learning_rate, rcfg.weight_decay
    cfg = rcfg.model

    def init(params):
        state = {}
        for group in stacked_groups(cfg, params):
            p = params[group[0]]
            lead = (len(group),) if _is_stacked(group) else ()
            shape = lead + tuple(p.shape)

            def zeros(shp, p=p):
                return torch.zeros(shp, dtype=torch.float32, device=p.device)
            if len(shape) < 2:
                per = [{"v": zeros(p.shape)} for _ in group]
            elif lead and p.dim() == 1:       # vc over the stack: shared
                vc = zeros(shape[-1:])
                per = [{"vr": zeros(()), "vc": vc} for _ in group]
            else:
                per = [{"vr": zeros(p.shape[:-1]),
                        "vc": zeros(p.shape[:-2] + p.shape[-1:])}
                       for _ in group]
            state.update(zip(group, per))
        return state

    @torch.no_grad()
    def update(grads, state, params, step):
        dev = _device(params)
        beta = 1.0 - _step_f32(step, dev) ** (-decay)
        for group in stacked_groups(cfg, params):
            stacked = _is_stacked(group)

            def stack(ts):
                return torch.stack(list(ts)) if stacked else ts[0]
            g = stack([grads[k].float() for k in group])
            p = stack([params[k].float() for k in group])
            s0 = state[group[0]]
            g2 = g * g + eps
            if "vr" in s0:
                vr = stack([state[k]["vr"] for k in group])
                shared = stacked and params[group[0]].dim() == 1
                vc = s0["vc"] if shared else stack(
                    [state[k]["vc"] for k in group])
                vr = beta * vr + (1 - beta) * g2.mean(-1)
                vc = beta * vc + (1 - beta) * g2.mean(-2)
                denom = vr.mean(-1, keepdim=True).clamp_min(eps)[..., None]
                v = vr[..., None] * vc[..., None, :] / denom
                for i, k in enumerate(group):
                    state[k] = {"vr": vr[i] if stacked else vr,
                                "vc": vc if shared or not stacked else vc[i]}
            else:
                v = beta * stack([state[k]["v"] for k in group]) \
                    + (1 - beta) * g2
                for i, k in enumerate(group):
                    state[k] = {"v": v[i] if stacked else v}
            u = g / torch.sqrt(v.clamp_min(eps))
            # update clipping (RMS <= clip)
            rms = torch.sqrt((u * u).mean() + eps)
            u = u / torch.clamp_min(rms / clip, 1.0)
            u = u + wd * p
            new = p - lr * u
            for i, k in enumerate(group):
                params[k].copy_(new[i] if stacked else new)
        return params, state

    return Optimizer(init, update)


def make_optimizer(rcfg: RunConfig) -> Optimizer:
    if rcfg.optimizer == "adafactor":
        return adafactor(rcfg)
    return adamw(rcfg)
