"""Mamba2 (SSD, state-space duality) mixer in the chunked-scan form.

Port of ``repro.models.ssm``.  Per head (state size N, head dim P):
    H_t = exp(A dt_t) H_{t-1} + dt_t (B_t (x) x_t)        H: [P, N]
    y_t = H_t C_t + D x_t
:func:`ssm_apply` splits the sequence into chunks of length L: a quadratic
intra-chunk term (the hand-written kernel
:func:`repro_torch.kernels.ssd_chunk.ssd_chunk_kernel` when ``use_pallas``,
else two einsums) plus a recurrence over the chunk states, a host loop
over chunks.  :func:`ssm_decode` takes one token; :func:`ssm_ref` steps it
over a sequence and is the oracle of the chunked form.

Dtypes follow the reference: ``dt`` is a softplus of an f32 sum, the SSD
terms run in f32, ``D x`` is added in f32, the gate ``y silu(z)`` runs in
the compute dtype and the norm in f32.

On a mesh the mixer runs on this rank's ``"model"`` shard of the SSM
heads where the rules split them: ``wz``, ``wx``, ``wdt``, ``conv_x``,
``A_log``, ``D``, ``dt_bias`` and ``norm`` column-parallel, ``wB``,
``wC``, ``conv_B`` and ``conv_C`` whole (each local head reads its
group), the SSD chunk (the kernel with ``use_pallas``) on the local
heads, the gated norm's sum of squares summed over the group, and ``wo``
row-parallel.  Under sequence parallelism the mixer gathers the sequence
in and reduce-scatters ``wo``'s partial sums back (:func:`ssm_apply`).
On a mesh the decode's conv state is its piece in the rules' layout
(:func:`conv_to_layout`, :func:`conv_from_layout`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel
from repro_torch.models.layers import dense_init, gen_device, rmsnorm
from repro_torch.runtime import sharding as shd


class Mamba2Mixer(nn.Module):
    """The parameters of one Mamba2 mixer, in the reference's layout and
    with its init (``repro.models.ssm.ssm_init``), drawn from
    ``generator`` on its device."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, *,
                 dtype=torch.float32):
        super().__init__()
        d, din = cfg.d_model, cfg.d_inner
        gst, nh, kk = cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_conv_kernel
        dev = gen_device(generator)

        def uniform(lo, hi):
            return torch.empty(nh, device=dev).uniform_(lo, hi,
                                                        generator=generator)
        self.wz = dense_init((d, din), generator, dtype=dtype)
        self.wx = dense_init((d, din), generator, dtype=dtype)
        self.wB = dense_init((d, gst), generator, dtype=dtype)
        self.wC = dense_init((d, gst), generator, dtype=dtype)
        self.wdt = dense_init((d, nh), generator, dtype=dtype)
        conv_scale = (1 / kk) ** 0.5
        self.conv_x = dense_init((kk, din), generator, scale=conv_scale,
                                 dtype=dtype)
        self.conv_B = dense_init((kk, gst), generator, scale=conv_scale,
                                 dtype=dtype)
        self.conv_C = dense_init((kk, gst), generator, scale=conv_scale,
                                 dtype=dtype)
        # A in [-16, -1): A_log ~ log(U[1, 16))
        self.A_log = nn.Parameter(torch.log(uniform(1.0, 16.0)).to(dtype))
        self.D = nn.Parameter(torch.ones(nh, device=dev, dtype=dtype))
        # softplus(dt_bias) ~ logspace[1e-3, 1e-1]
        dt = torch.exp(uniform(math.log(1e-3), math.log(1e-1)))
        self.dt_bias = nn.Parameter(
            (dt + torch.log(-torch.expm1(-dt))).to(dtype))
        self.norm = nn.Parameter(torch.ones(din, device=dev, dtype=dtype))
        self.wo = dense_init((din, d), generator, dtype=dtype)


def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x: [B, S, C]; w: [K, C]; state: [B, K-1, C]
    previous inputs or None.  Returns (y [B, S, C], new state)."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros(x.shape[0], k - 1, x.shape[2])
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y, new_state


def _segsum_mask(a):
    """a: [..., L] log-decays -> M[..., t, s] = exp(sum_{s<u<=t} a_u) for
    s <= t, else 0.  The mask goes in before the exp: above the diagonal
    ``diff`` is positive and can overflow to inf, and the backward of a
    mask after the exp would multiply its zero gradient by that inf."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    tri = torch.ones(L, L, dtype=torch.bool, device=a.device).tril()
    return torch.exp(torch.where(tri, diff, float("-inf")))


# the leaves split over the SSM heads (``ssm_heads``/``ssm_inner``); wB,
# wC, conv_B and conv_C (``ssm_state``) stay whole
_PER_HEAD = ("wz", "wx", "wdt", "conv_x", "A_log", "D", "dt_bias", "norm",
             "wo")


def _weights(p: Mamba2Mixer):
    """(the mixer's weights by name, the heads' ``"model"`` shard or None).
    Where the rules split the heads, the per-head leaves are this rank's;
    where they split the inner width but not the heads (a head count the
    axis does not divide), those leaves are gathered whole and the mixer
    runs whole on every rank."""
    sh = shd.model_shard(p, "A_log")
    w = {k: getattr(p, k) for k in _PER_HEAD + ("wB", "wC", "conv_B",
                                                "conv_C")}
    if sh is None:
        w = {k: shd.gather_from_model(v, shd.model_shard(p, k))
             for k, v in w.items()}
    return w, sh


def _project(w: dict, sh, x, sp=None):
    """z, x, B, C and dt of ``x``: the per-head projections
    column-parallel, B and C whole (computed alike on every rank).  Under
    sequence parallelism (``sp``) ``x`` entered the heads in its
    ``gather_seq``, and B and C read it once over the group."""
    cd = x.dtype
    if sp is None:
        xt, xg = shd.copy_to_model(x, sh), x
    else:
        xt, xg = x, shd.once_over_model(x, sp)
    z = xt @ w["wz"].to(cd)
    xin = xt @ w["wx"].to(cd)
    B = xg @ w["wB"].to(cd)
    C = xg @ w["wC"].to(cd)
    dt = F.softplus((xt @ w["wdt"].to(cd)).float() + w["dt_bias"].float())
    return z, xin, B, C, dt


def _conv_silu(w: dict, sh, xin, B, C, state):
    """The causal conv over [x, B, C] and its SiLU, split back apart; B
    and C enter the local heads after it.  The conv state holds the
    channels in that order (this rank's x channels, then B and C)."""
    conv_in = torch.cat([xin, B, C], dim=-1)
    conv_w = torch.cat([w["conv_x"], w["conv_B"], w["conv_C"]], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, conv_w, state)
    conv_out = F.silu(conv_out)
    din, gst = xin.shape[-1], B.shape[-1]
    return (conv_out[..., :din],
            shd.copy_to_model(conv_out[..., din:din + gst], sh),
            shd.copy_to_model(conv_out[..., din + gst:], sh), conv_state)


def _per_head(cfg: ModelConfig, sh, t, dim: int):
    """Group tensors [..., G, N] -> [..., H', N], one per local head: head
    ``h`` reads group ``h // (heads / G)``."""
    hpg = cfg.ssm_heads // cfg.ssm_groups
    if sh is None:
        return t.repeat_interleave(hpg, dim=dim)
    idx = torch.arange(sh.start, sh.stop, device=t.device) // hpg
    return t.index_select(dim, idx)


def _gated_norm(cfg: ModelConfig, sh, y, w):
    """RMSNorm over the whole ``d_inner``: on the local heads' channels
    the sum of squares is summed over the group before the scale."""
    if sh is None:
        return rmsnorm(y, w, cfg.norm_eps)
    dt = y.dtype
    y = y.float()
    ss = shd.reduce_from_model(y.square().sum(-1, keepdim=True), sh)
    ss = shd.copy_to_model(ss, sh)
    return (y * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
            * w.float()).to(dt)


def _finish(cfg: ModelConfig, w: dict, sh, y, x_heads, z, sp=None):
    """The D skip, the gate, the gated norm and ``wo`` (row-parallel: the
    partial sums summed over the group, or left to the caller under
    ``sp``)."""
    b, s = y.shape[0], y.shape[1]
    y = y + w["D"].float()[None, None, :, None] * x_heads.float()
    y = y.reshape(b, s, -1).to(z.dtype)
    y = y * F.silu(z)
    y = _gated_norm(cfg, sh, y, w["norm"])
    y = y @ w["wo"].to(z.dtype)
    return y if sp is not None else shd.reduce_from_model(y, sh)


def ssm_apply(cfg: ModelConfig, p: Mamba2Mixer, x, *, chunk: int = 128,
              initial_state=None, use_pallas: bool = False, sp=None):
    """x: [B, S, d].  Returns (out [B, S, d], (conv_state, ssm_state)), the
    SSM state [B, heads, P, N] in f32 (on a mesh, this rank's heads).

    Under sequence parallelism (``sp``: ``x`` and ``out`` hold this rank's
    positions) the mixer reads the whole sequence: on split SSM heads
    through ``gather_seq`` (the SSD chunk on the local heads over every
    position, ``wo``'s partial sums reduce-scattered onto the positions),
    on heads the fallback left whole on every rank alike (each keeps its
    positions).  The states are those of the whole sequence."""
    if sp is not None:
        if shd.model_shard(p, "A_log") is None:
            out, states = ssm_apply(
                cfg, p, shd.gather_from_model(x, sp), chunk=chunk,
                initial_state=initial_state, use_pallas=use_pallas)
            return shd.split_seq(out, sp), states
        x = shd.gather_seq(x, sp)
    b, s, _ = x.shape
    w, sh = _weights(p)
    nh, hd, st, g = (w["A_log"].shape[0], cfg.ssm_head_dim, cfg.ssm_state,
                     cfg.ssm_groups)
    z, xin, B, C, dt = _project(w, sh, x, sp)
    conv_state_in = initial_state[0] if initial_state is not None else None
    xin, B, C, conv_state = _conv_silu(w, sh, xin, B, C, conv_state_in)

    L = min(chunk, s)
    while s % L:
        L -= 1
    nc = s // L
    xh = xin.reshape(b, nc, L, nh, hd).float()
    Bh = _per_head(cfg, sh, B.reshape(b, nc, L, g, st).float(), 3)
    Ch = _per_head(cfg, sh, C.reshape(b, nc, L, g, st).float(), 3)
    dtc = dt.reshape(b, nc, L, nh)
    A = -torch.exp(w["A_log"].float())
    a_t = (dtc * A).transpose(-1, -2)                    # [b, nc, nh, L]
    xdt = xh * dtc[..., None]

    # intra-chunk, quadratic
    if use_pallas:
        cells = b * nc * nh

        def cell_major(t):        # [b, nc, L, nh, k] -> [cells, L, k]
            return t.permute(0, 1, 3, 2, 4).reshape(cells, L, -1) \
                .contiguous()
        yg = ssd_chunk_kernel(cell_major(Ch), cell_major(Bh), cell_major(xdt),
                              a_t.reshape(cells, L).contiguous())
        y_intra = yg.reshape(b, nc, nh, L, hd).permute(0, 1, 3, 2, 4)
    else:
        G = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)
        y_intra = torch.einsum("bchls,bcshp->bclhp", G * _segsum_mask(a_t),
                               xdt)

    # chunk states
    cs = torch.cumsum(a_t, dim=-1)
    decay_to_end = torch.exp(cs[..., -1:] - cs)          # [b, nc, nh, L]
    S_c = torch.einsum("bchl,bclhn,bclhp->bchpn", decay_to_end, Bh, xdt)

    # inter-chunk recurrence; the state before each chunk
    chunk_decay = torch.exp(cs[..., -1])                 # [b, nc, nh]
    h = (initial_state[1].float() if initial_state is not None
         else x.new_zeros(b, nh, hd, st, dtype=torch.float32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                # [b, nc, nh, P, N]

    y_inter = torch.einsum("bclhn,bchpn,bchl->bclhp", Ch, h_prevs,
                           torch.exp(cs))
    y = (y_intra + y_inter).reshape(b, s, nh, hd)
    out = _finish(cfg, w, sh, y, xin.reshape(b, s, nh, hd), z, sp)
    return shd.scatter_seq(out, sp), (conv_state, h.float())


CONV_AXES = ("batch", None, "ssm_inner")   # a layer's conv state


def conv_layout(cfg: ModelConfig, p: Mamba2Mixer, sh):
    """(the rules' piece ``(dim, start, stop)`` of a layer's conv state
    [B, K-1, x | B | C] on this rank, or None where it is whole; the
    channels of the mixer's own layout: the x channels of its heads
    ``sh`` (all without a shard), then B and C)."""
    c = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    piece = shd.model_piece(CONV_AXES, (1, 1, c), shd.model_group(p))
    if sh is None:
        return piece, torch.arange(c)
    p_ = cfg.ssm_head_dim
    return piece, torch.cat([torch.arange(sh.start * p_, sh.stop * p_),
                             torch.arange(cfg.d_inner, c)])


def conv_to_layout(cfg: ModelConfig, p: Mamba2Mixer, conv, sh):
    """A conv state in the mixer's layout (its heads' x channels, B, C),
    the rules' piece of the whole one on a mesh: the pieces gathered over
    ``"model"`` and the mixer's channels kept."""
    piece, keep = conv_layout(cfg, p, sh)
    if piece is not None:
        conv = shd.gather_from_model(conv, shd.ModelShard(
            piece[0], piece[1], piece[2], shd.model_group(p)))
    return conv.index_select(-1, keep.to(conv.device))


def conv_from_layout(cfg: ModelConfig, p: Mamba2Mixer, conv, sh):
    """A conv state in the mixer's layout -> this rank's piece of the
    whole one in the rules' layout: the x channels of every head gathered
    over the heads' group."""
    piece, _ = conv_layout(cfg, p, sh)
    if sh is not None:
        n_x = (sh.stop - sh.start) * cfg.ssm_head_dim
        conv = torch.cat([shd.gather_from_model(conv[..., :n_x], sh,
                                                dim=-1),
                          conv[..., n_x:]], dim=-1)
    return conv if piece is None else conv[..., piece[1]:piece[2]]


def ssm_decode(cfg: ModelConfig, p: Mamba2Mixer, x, conv_state, ssm_state):
    """One-token decode.  x: [B, 1, d]; states as :func:`ssm_apply` returns
    them, but on a mesh the conv state is this rank's piece of the whole
    one in the rules' layout (split over ``"model"`` on its channels
    where they divide), read and returned so.  The conv state is taken in
    ``x.dtype`` and returned in it."""
    b = x.shape[0]
    w, sh = _weights(p)
    nh, hd, st, g = (w["A_log"].shape[0], cfg.ssm_head_dim, cfg.ssm_state,
                     cfg.ssm_groups)
    z, xin, B, C, dt = _project(w, sh, x)
    on_mesh = shd.model_group(p) is not None
    conv_in = held = conv_state.to(xin.dtype)
    if on_mesh:
        conv_in = conv_to_layout(cfg, p, held, sh)
    xin, B, C, conv_state = _conv_silu(w, sh, xin, B, C, conv_in)
    if on_mesh:      # the held piece moves by one row: the new inputs'
        conv_state = torch.cat([held[:, 1:], conv_from_layout(
            cfg, p, conv_state[:, -1:], sh)], dim=1)
    xh = xin.reshape(b, nh, hd).float()
    Bh = _per_head(cfg, sh, B.reshape(b, g, st), 1).float()
    Ch = _per_head(cfg, sh, C.reshape(b, g, st), 1).float()
    dt1 = dt[:, 0]                                       # [b, nh]
    A = -torch.exp(w["A_log"].float())
    dec = torch.exp(dt1 * A[None, :])
    h = ssm_state.float() * dec[..., None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt1, xh, Bh)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch)[:, None]    # [b, 1, nh, hd]
    out = _finish(cfg, w, sh, y, xh[:, None], z)
    return out, (conv_state, h)


def ssm_ref(cfg: ModelConfig, p: Mamba2Mixer, x):
    """Sequential oracle: :func:`ssm_decode` stepped over every position."""
    b, s, _ = x.shape
    conv_state = x.new_zeros(b, cfg.ssm_conv_kernel - 1,
                             cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
    h = x.new_zeros(b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                    dtype=torch.float32)
    outs = []
    for t in range(s):
        o, (conv_state, h) = ssm_decode(cfg, p, x[:, t:t + 1], conv_state, h)
        outs.append(o)
    return torch.cat(outs, dim=1)
