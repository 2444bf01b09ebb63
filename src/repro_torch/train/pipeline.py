"""GPipe-style pipeline parallelism over a process group: port of
``repro.train.pipeline``.

Stage ``s`` of ``S`` holds the layers of blocks ``[s·per, (s+1)·per)``
(``per = num_blocks / S``): layers ``j·n + i`` for those blocks ``j``, with
``n = len(cfg.full_pattern)``.  Stage 0 embeds; the last stage applies
the final norm and the head.  Microbatches stream through the stages in
``nmb + S − 1`` ticks; at each tick a stage sends the [mb, S, d]
activation it finished to the next stage and receives its next input
from the previous one (``batch_isend_irecv``).  The last stage's logits
are broadcast to every rank of the group (the reference's ``psum`` of
masked logits).

The schedule differentiates through ``torch.autograd``: each boundary
transfer is an autograd function whose backward sends the gradient up
the chain, so ``backward()`` on the logits, called on every rank of the
group (it is collective), gives every stage's parameters their
gradients.  The logits on every rank are the last stage's, and the
backward takes the last stage's own gradient of them: each rank's copy is
a replica, not a summand.  Backward transfers run in descending
microbatch order on every rank, and each carries its microbatch as tag.

Gloo cannot send CUDA tensors, and NCCL refuses two ranks on one device,
so when the group's backend is gloo and the stage computes on a card,
boundary tensors cross through host memory (``host_staged``).  That is
the transport only: the stages compute on their device.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers as L
from repro_torch.models import lm


def stage_layers(cfg: ModelConfig, stage: int, num_stages: int) -> list[int]:
    """The layer indices stage ``stage`` holds, in order."""
    if cfg.num_blocks % num_stages:
        raise ValueError(f"{cfg.num_blocks} blocks do not split into "
                         f"{num_stages} stages")
    per, n = cfg.num_blocks // num_stages, len(cfg.full_pattern)
    return [j * n + i for j in range(stage * per, (stage + 1) * per)
            for i in range(n)]


def _axis_group(mesh, axis: str):
    """(group, size, rank) of ``axis``: a ``DeviceMesh`` dim or the wave
    engine's one-axis :class:`repro_torch.launch.mesh.Mesh`."""
    if hasattr(mesh, "get_group"):
        d = list(mesh.mesh_dim_names).index(axis)
        return mesh.get_group(d), mesh.size(d), mesh.get_local_rank(d)
    if mesh.axis != axis:
        raise ValueError(f"mesh axis {mesh.axis!r}, not {axis!r}")
    return mesh.group, mesh.size, mesh.rank


def keep_stage(cfg: ModelConfig, model: lm.LM, mesh, axis: str) -> lm.LM:
    """``model`` holding only this rank's stage: the other layers become
    empty modules, the embedding stays on the first and last stages
    (the head may be tied to it), the final norm on the last."""
    _, size, rank = _axis_group(mesh, axis)
    mine = set(stage_layers(cfg, rank, size))
    for l in range(len(model.layers)):
        if l not in mine:
            model.layers[l] = nn.Module()
    if rank not in (0, size - 1):
        model.embed = nn.Module()
    if rank != size - 1:
        model.final_norm = None
    return model


class _Link:
    """The point-to-point transport of one rank of the pipe."""

    def __init__(self, group, rank, device):
        self.group, self.rank = group, rank
        self.device = device
        self.host_staged = (device.type == "cuda" and
                            dist.get_backend(group) == "gloo")
        self.bytes_sent = 0     # activations to the next stage
        self.bytes_back = 0     # gradients to the previous stage

    def peer(self, r: int) -> int:
        return (r if self.group is None or self.group == dist.group.WORLD
                else dist.get_global_rank(self.group, r))

    def wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach().contiguous()
        return t.cpu() if self.host_staged else t

    def buffer(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=(
            "cpu" if self.host_staged else self.device))

    def exchange(self, send, recv):
        """Send ``send`` to the next rank and receive ``recv`` from the
        previous one, as one batch; each is ``(tensor, microbatch)`` or
        None, the microbatch its tag."""
        ops = []
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send[0],
                                  self.peer(self.rank + 1), self.group,
                                  send[1]))
            self.bytes_sent += send[0].numel() * send[0].element_size()
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv[0],
                                  self.peer(self.rank - 1), self.group,
                                  recv[1]))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()

    def arrive(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.host_staged else t


class _SendDone(torch.autograd.Function):
    """Marks activation ``y`` of microbatch ``tag`` as sent (the send ran
    in the tick's exchange); its backward receives ``y``'s gradient from
    the next stage.  ``after`` chains the marks so that backward receives
    run in descending microbatch order."""

    @staticmethod
    def forward(ctx, y, after, link, tag):
        ctx.link, ctx.tag = link, tag
        ctx.meta = (y.shape, y.dtype)
        ctx.after = (after.shape, after.device)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        link = ctx.link
        g = link.buffer(*ctx.meta)
        dist.recv(g, link.peer(link.rank + 1), link.group, tag=ctx.tag)
        return link.arrive(g), torch.zeros(ctx.after[0], device=ctx.after[1]), None, None


class _Arrived(torch.autograd.Function):
    """Activation ``x`` of microbatch ``tag``, received from the previous
    stage; its backward sends ``x``'s gradient back there.  ``after`` (the
    previous microbatch's input) orders the backward sends."""

    @staticmethod
    def forward(ctx, x, after, link, tag):
        ctx.link, ctx.tag, ctx.after = link, tag, after.shape
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        link = ctx.link
        link.bytes_back += g.numel() * g.element_size()
        dist.send(link.wire(g), link.peer(link.rank - 1), link.group,
                  tag=ctx.tag)
        return None, g.new_zeros(ctx.after), None, None


class _FromLast(torch.autograd.Function):
    """The last stage's logits on every rank (a broadcast).  Its backward
    passes the last stage's own gradient to its logits and starts every
    other rank's backward chain through ``chain``."""

    @staticmethod
    def forward(ctx, logits, chain, link, src, shape, dtype):
        ctx.src, ctx.link = src, link
        ctx.chain = chain.shape
        buf = link.wire(logits) if link.rank == src else link.buffer(shape,
                                                                     dtype)
        dist.broadcast(buf, link.peer(src), link.group)
        return link.arrive(buf).clone() if link.rank != src else \
            logits.clone()

    @staticmethod
    def backward(ctx, g):
        own = g if ctx.link.rank == ctx.src else None
        return own, g.new_zeros(ctx.chain), None, None, None, None


def pipeline_forward(cfg: ModelConfig, rcfg: RunConfig, mesh, axis: str,
                     num_microbatches: int):
    """``f(model, tokens) -> logits`` running the layer stack as the
    ``axis``-many stages of ``mesh`` (a ``DeviceMesh`` or the wave
    engine's one-axis ``Mesh``), ``num_microbatches`` microbatches.
    ``model`` may hold only this rank's stage (:func:`keep_stage`).
    ``f.link`` is the rank's transport after a call (``host_staged``,
    ``bytes_sent`` forward, ``bytes_back`` in the backward)."""
    group, num_stages, stage = _axis_group(mesh, axis)
    mine = stage_layers(cfg, stage, num_stages)
    pattern = cfg.full_pattern
    last = num_stages - 1
    nmb = num_microbatches

    def f(model, tokens):
        device = tokens.device
        b, s = tokens.shape
        if b % nmb:
            raise ValueError(f"batch {b} not divisible by {nmb} microbatches")
        mb = b // nmb
        cd = getattr(torch, rcfg.compute_dtype)
        link = _Link(group, stage, device)
        f.link = link
        positions = torch.arange(s, dtype=torch.int32,
                                 device=device).expand(mb, s)
        layer_fn = lm.remat(lm.apply_layer, rcfg)
        grad = torch.is_grad_enabled()
        anchor = torch.zeros((), device=device, requires_grad=grad)
        prev_in, prev_sent = anchor, anchor
        outs, pending = [], None      # pending: (wire tensor, microbatch)
        for t in range(nmb + num_stages - 1):
            m = t - stage
            active = 0 <= m < nmb
            recv = (link.buffer((mb, s, cfg.d_model), cd)
                    if active and stage > 0 else None)
            link.exchange(pending, None if recv is None else (recv, m))
            pending = None
            if not active:
                continue
            if stage == 0:
                x, _ = lm._embed_in(cfg, rcfg, model,
                                    tokens[m * mb:(m + 1) * mb])
            else:
                x = _Arrived.apply(link.arrive(recv), prev_in, link, m)
                prev_in = x
            for l in mine:
                x, _, _ = layer_fn(cfg, rcfg, pattern[l % len(pattern)],
                                   model.layers[l], x, positions,
                                   mode="train")
            if stage == last:
                x = L.rmsnorm(x, model.final_norm, cfg.norm_eps,
                              zero_centered=cfg.use_post_norm)
                outs.append(L.lm_logits(cfg, model.embed, x))
            else:
                pending = (link.wire(x), m)
                prev_sent = _SendDone.apply(x, prev_sent, link, m)
        local = torch.cat(outs) if outs else None
        return _FromLast.apply(local, prev_sent, link, last,
                               (b, s, cfg.padded_vocab), cd)

    return f
