"""Error-feedback int8 gradient compression for the data-parallel
all-reduce: port of ``repro.train.grad_compression``.

Cross-pod gradient reduction rides the slowest links; int8 quantization
cuts wire bytes 4x while error feedback (Karimireddy et al., 2019) keeps
convergence — the quantization residual is carried into the next step
instead of dropped.  Each rank of a ``torch.distributed`` process group
quantizes (grad + ef) per leaf with one symmetric scale, all-gathers the
int8 payloads and the f32 scales, and averages the dequantised copies
locally.  ``group=None`` is a group of one rank (nothing on the wire).
"""
from __future__ import annotations

import torch


def init_error_feedback(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _quantize(g, ef):
    x = g.float() + ef
    scale = x.abs().amax().clamp_min(1e-12) / 127.0
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    err = x - q.float() * scale
    return q, scale, err


def _all_gather(x, group):
    """[n, *x.shape]: ``x`` of every rank of ``group``, in rank order."""
    if group is None:
        return x[None]
    import torch.distributed as dist
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out)


def compressed_psum_mean(grads: dict, ef: dict, group=None):
    """Per-leaf int8 all-gather + local dequant-mean over ``group``.
    Returns (mean grads, new error feedback)."""
    mean, new_ef = {}, {}
    for k, g in grads.items():
        q, scale, err = _quantize(g, ef[k])
        qs = _all_gather(q, group)                        # int8 on the wire
        ss = _all_gather(scale.reshape(1), group)         # [n, 1] f32
        deq = qs.float() * ss.reshape((-1,) + (1,) * g.dim())
        mean[k] = deq.mean(0).to(g.dtype)
        new_ef[k] = err
    return mean, new_ef


def make_compressed_dp_step(loss_fn, opt, group=None):
    """Explicit-DP train step: per-rank grads -> compressed mean ->
    update.

    ``loss_fn(params, batch) -> (loss, metrics)``, with ``params`` the
    tensors it reads (the model's own parameters); ``batch`` is this
    rank's slice.  Params, optimizer state and ef are replicated: every
    rank applies the same mean, so they stay equal.  The step returns
    (params, opt_state, ef, loss averaged over the group)."""
    def step(params, opt_state, ef, step_i, batch):
        loss, _ = loss_fn(params, batch)
        g = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
        g, ef2 = compressed_psum_mean(dict(zip(params, g)), ef, group)
        new_p, new_o = opt.update(g, opt_state, params, step_i)
        loss = loss.detach()
        if group is not None:
            import torch.distributed as dist
            dist.all_reduce(loss, group=group)
            loss = loss / dist.get_world_size(group)
        return new_p, new_o, ef2, loss

    return step
