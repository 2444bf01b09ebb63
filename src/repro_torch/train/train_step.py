"""Train step: loss → grads (microbatched) → clip → optimizer update.

Port of ``repro.train.train_step``.  The model is an ``nn.Module`` built
by :func:`repro_torch.models.model.init`; the parameters the step takes
and returns are ``dict(model.named_parameters())``, the model's own
tensors, which the optimizer updates in place.  Gradients come from
``torch.autograd.grad`` as a dict over the same names.  Microbatching
(sequential gradient accumulation in f32) bounds activation memory
independently of the global batch.  Nothing in a step reads a value on
the host: the loss, the norm and the metrics stay on the device.

The reference's sharding hook has nothing to do on one card:
:func:`constrain_like_params` returns its tree as it is, so
``rcfg.shard_grads`` changes nothing.  The explicit data-parallel step
with int8 gradient compression is :mod:`repro_torch.train.grad_compression`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model as M
from repro_torch.train.optimizer import Optimizer, make_optimizer


def constrain_like_params(tree):
    """Pins a gradient tree to the parameters' sharding in the reference;
    on one card there is none, so the tree comes back unchanged."""
    return tree


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


def clip_by_global_norm(tree: dict, max_norm: float):
    """Scales every leaf (in place) so the global norm is at most
    ``max_norm``.  Returns (tree, the norm before clipping)."""
    g = global_norm(tree)
    scale = torch.clamp_max(max_norm / g.clamp_min(1e-12), 1.0)
    for x in tree.values():
        x.mul_(scale)
    return tree, g


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    def check(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        return b // n
    size = {k: check(x) for k, x in batch.items()}
    return [{k: x[i * size[k]:(i + 1) * size[k]] for k, x in batch.items()}
            for i in range(n)]


def _value_and_grad(cfg, rcfg, model, params: dict, batch):
    loss, metrics = M.loss_fn(cfg, rcfg, model, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(params, grads)))


def grads_fn(cfg: ModelConfig, rcfg: RunConfig, model, batch):
    """Microbatched grads + metrics (mean over microbatches).  Returns
    (grads, loss, metrics); with microbatches the grads and metrics are
    f32."""
    params = dict(model.named_parameters())
    n = rcfg.microbatches
    if n <= 1:
        loss, metrics, grads = _value_and_grad(cfg, rcfg, model, params,
                                               batch)
        return grads, loss, metrics

    g_acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    l_acc, m_acc = None, None
    for mb in _split_microbatches(batch, n):
        loss, metrics, g = _value_and_grad(cfg, rcfg, model, params, mb)
        for k, a in g.items():
            g_acc[k].add_(a.float())
        l_acc = loss / n if l_acc is None else l_acc + loss / n
        m = {k: v.float() / n for k, v in metrics.items()}
        m_acc = m if m_acc is None else {k: m_acc[k] + m[k] for k in m}
    for a in g_acc.values():
        a.div_(n)
    return g_acc, l_acc, m_acc


def bind_params(model, params: dict) -> dict:
    """The model's own parameters, holding the values of ``params`` (a
    restored checkpoint's tensors are copied in; the model's own pass
    through)."""
    own = dict(model.named_parameters())
    if own.keys() != params.keys():
        raise ValueError(f"parameters {sorted(set(own) ^ set(params))} "
                         f"differ from the model's")
    with torch.no_grad():
        for k, p in own.items():
            if params[k] is not p:
                p.copy_(params[k])
    return own


def _on(batch: dict, device) -> dict:
    return {k: (torch.from_numpy(x) if isinstance(x, np.ndarray)
                else x).to(device) for k, x in batch.items()}


def make_train_step(cfg: ModelConfig, rcfg: RunConfig, model,
                    opt: Optimizer | None = None):
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    metrics)`` on ``model``'s device; ``batch`` may hold numpy arrays or
    tensors, ``step`` is an int or a 0-d tensor."""
    opt = opt or make_optimizer(rcfg)
    device = next(model.parameters()).device

    def train_step(params, opt_state, step, batch):
        params = bind_params(model, params)
        grads, loss, metrics = grads_fn(cfg, rcfg, model, _on(batch, device))
        grads, gnorm = clip_by_global_norm(grads, rcfg.grad_clip)
        params, opt_state = opt.update(grads, opt_state, params, step)
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm, step=step + 1)
        return params, opt_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, rcfg: RunConfig,
                     opt: Optimizer | None = None, *, seed: int = 0,
                     device="cuda"):
    """(model, params, opt_state): weights drawn on ``device`` from
    ``seed`` in ``rcfg.param_dtype``, and the optimizer's zero state."""
    model = M.init(cfg, seed, getattr(torch, rcfg.param_dtype),
                   device=resolve_device(device))
    params = dict(model.named_parameters())
    return model, params, (opt or make_optimizer(rcfg)).init(params)
