"""Logical-axis sharding rules with divisibility fallback: port of
``repro.runtime.sharding``.

Every parameter, optimizer state, cache leaf and activation carries a
tuple of *logical* axis names (e.g. ``("vocab", "embed")``).  A
:class:`ShardingRules` table maps logical names to mesh axis names (or
``None`` for replicated).  The mapping is applied with a divisibility
check: a dimension that does not divide the mesh axis size falls back to
replication (e.g. ``kv_heads=8`` on a 16-way ``model`` axis), and a mesh
axis shards at most one dimension.  The tables and the resolution are
the reference's.

Where the reference walks JAX key paths of stacked block parameters, the
port resolves its own names: parameters are per layer
(``layers.7.mixer.wq``, ``encoder.3.mlp.wi``, ``decoder.0.cross.wk``,
``embed.embedding``, ``final_norm``), so a ``layers.N``, ``encoder.N`` or
``decoder.N`` parent takes the place of the reference's stack keys and
the reference's leading replicated layer axis does not exist here.
AdamW's state is ``{"m": {name: t}, "v": {name: t}}``, Adafactor's is
``{name: {"vr", "vc"} | {"v"}}``, and the decode caches of
``models.model.init_cache`` keep the reference's stacked layout, so their
leaves resolve as the reference's do.

On a ``torch.distributed`` :class:`~torch.distributed.device_mesh.
DeviceMesh` a spec becomes DTensor placements (:func:`placements_for`):
``Shard(d)`` on every mesh dim named in dim ``d``'s entry, ``Replicate()``
elsewhere.  A dim sharded over ``("pod", "data")`` is split pod-major, as
in JAX: DTensor orders the shards of one dim by mesh dim, and the rules'
tuples name the mesh dims in the mesh's order.

Compute on a mesh is tensor-parallel over ``"model"`` (the last section):
a layer reads its weights' ``"model"`` shards, gathered over the batch
axes only, and crosses between replicated and sharded activations
through :func:`copy_to_model` and :func:`reduce_from_model`, as XLA's
SPMD partitioner runs the reference's einsums on the rules' shards.
Under sequence parallelism (the rules' ``act_seq``) the activations
between layers hold each rank's positions and cross to the whole
sequence through :func:`gather_seq`, :func:`scatter_seq` and
:func:`split_seq`; :func:`seq_shard` gives a rank its positions of a
sequence (``act_seq``) or a cache ring (``cache_seq``), and
:func:`model_piece` its piece of any tensor the rules split over
``"model"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

# Logical axis -> mesh axis (or tuple of mesh axes, or None).
LogicalRules = Mapping[str, Any]

# The default TRAIN rules for the production mesh ("pod"?, "data", "model"):
#   - FSDP: the model/embed dimension of weights shards over "data".
#   - TP:   heads / ffn / vocab / expert dimensions shard over "model".
#   - DP:   the batch dimension of activations shards over ("pod", "data").
#   - SP:   long KV caches shard their sequence dimension over "model".
TRAIN_RULES: LogicalRules = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": "model",       # sequence parallelism (rcfg.seq_parallel)
    "embed": "data",          # FSDP axis for params
    "act_embed": None,        # activations keep embed replicated
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_capacity": "data",
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "conv_kernel": None,
    "cache_seq": "model",
    "frames": None,
    "norm": None,
    "pos": None,
}

# Serving baseline uses the same weight layout (ZeRO-3 style: weights are
# gathered over "data" per layer).
SERVE_RULES: LogicalRules = dict(TRAIN_RULES)

# TP-only serving layout: no FSDP dimension, so decode and prefill never
# gather weights over "data".
SERVE_TP_RULES: LogicalRules = dict(TRAIN_RULES)
SERVE_TP_RULES.update({"embed": None})

# the mesh dims a batch is split over, in mesh order
BATCH_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """A partition spec: per tensor dim ``None``, a mesh axis name or a
    tuple of names, trailing ``None``s trimmed (``jax.sharding.
    PartitionSpec``'s meaning)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or of any object whose
    ``shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: LogicalRules

    def spec_for(self, logical_axes: Sequence[str | None],
                 shape: Sequence[int], mesh) -> PartitionSpec:
        """The spec of a tensor, dropping non-dividing, missing or
        already used mesh axes."""
        sizes = mesh_shape(mesh)
        used: set[str] = set()
        out = []
        for dim, name in zip(shape, logical_axes):
            mesh_axes = self.rules.get(name) if name is not None else None
            if mesh_axes is None:
                out.append(None)
                continue
            if isinstance(mesh_axes, str):
                mesh_axes = (mesh_axes,)
            # keep only axes present in the mesh, unused so far, and dividing
            picked = []
            size = 1
            for ax in mesh_axes:
                if ax in sizes and ax not in used:
                    if int(dim) % (size * sizes[ax]) == 0:
                        picked.append(ax)
                        size *= sizes[ax]
            used.update(picked)
            if not picked:
                out.append(None)
            elif len(picked) == 1:
                out.append(picked[0])
            else:
                out.append(tuple(picked))
        while out and out[-1] is None:
            out.pop()
        return PartitionSpec(*out)

    def placements_for(self, logical_axes, shape, device_mesh) -> list:
        return placements_for(self.spec_for(logical_axes, shape,
                                            device_mesh), device_mesh)


def placements_for(spec: Sequence, device_mesh) -> list:
    """DTensor placements of ``spec`` on ``device_mesh``.  A mesh dim of
    size 1 holds the whole tensor either way and stays ``Replicate()``,
    which spares a gather over one rank at every read."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(device_mesh.mesh_dim_names)
    sizes = mesh_shape(device_mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if sizes[ax] > 1:
                out[names.index(ax)] = Shard(d)
    return out


# ---------------------------------------------------------------------------
# Name-based logical-axes resolution for the port's trees.
#
# Parameter names are globally meaningful; this table is the single source
# of truth for how each weight shards.  Disambiguation uses the parent key
# ("mixer"/"mlp"/"cross") and the rank (MoE weights are 3-D).
# ---------------------------------------------------------------------------

_NAME_AXES = {
    "embedding": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    "pos_embedding": ("pos", "embed"),
    "enc_pos": ("pos", "embed"),
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "bq": ("heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
    "q_norm": ("norm",),
    "k_norm": ("norm",),
    "router": ("embed", "experts"),
    "wz": ("embed", "ssm_inner"),
    "wx": ("embed", "ssm_inner"),
    "wB": ("embed", "ssm_state"),
    "wC": ("embed", "ssm_state"),
    "wdt": ("embed", "ssm_heads"),
    "conv_x": ("conv_kernel", "ssm_inner"),
    "conv_B": ("conv_kernel", "ssm_state"),
    "conv_C": ("conv_kernel", "ssm_state"),
    "A_log": ("ssm_heads",),
    "D": ("ssm_heads",),
    "dt_bias": ("ssm_heads",),
}

# per-layer parents: the reference's stack keys ("blocks"/"encoder"/
# "decoder") become these, each followed by the layer index
_LAYER_KEYS = ("layers", "encoder", "decoder")

_CACHE_AXES = {
    "k": (None, "batch", "cache_seq", "kv_heads", "head_dim"),
    "v": (None, "batch", "cache_seq", "kv_heads", "head_dim"),
    "cross_k": (None, "batch", "cache_seq", "kv_heads", "head_dim"),
    "cross_v": (None, "batch", "cache_seq", "kv_heads", "head_dim"),
    "pos": (None, None),
    "conv": (None, "batch", None, "ssm_inner"),
    "ssm": (None, "batch", "ssm_heads", None, None),
}


def _keys(path) -> list[str]:
    if isinstance(path, str):
        return path.split(".")
    return [str(k) for k in path]


def _is_vector_param(name: str) -> bool:
    """A parameter that is 1-D in the port (a norm scale or a per-head
    vector): Adafactor shares one column factor ``vc`` of its full length
    over its layers."""
    axes = _NAME_AXES.get(name)
    return (len(axes) == 1) if axes else "norm" in name


def resolve_axes(path, ndim: int) -> tuple:
    """Logical axes of the leaf at ``path`` (a dotted name or a sequence of
    keys) with ``ndim`` dims."""
    keys = _keys(path)
    name = keys[-1]
    parents = keys[:-1]

    # KV/SSM cache leaves (decode path)
    if name in _CACHE_AXES and len(_CACHE_AXES[name]) == ndim and \
            not any(k in _LAYER_KEYS for k in parents):
        return _CACHE_AXES[name]
    # Adafactor factored second moments inherit the parent param's axes
    if name == "vr":
        return resolve_axes(parents, ndim + 1)[:-1]
    if name == "vc":
        if _is_vector_param(parents[-1]):   # a vector's shared column factor
            return resolve_axes(parents, ndim)[-1:]
        full = resolve_axes(parents, ndim + 1)
        return full[:-2] + full[-1:]
    if name in ("v", "m", "ef") and parents and \
            parents[-1] not in _LAYER_KEYS:
        # per-param optimizer state dicts ({name: {"v"}}); AdamW's
        # {"m": {name: ...}} paths end with the param name instead.
        if parents[-1] in _NAME_AXES or parents[-1] in (
                "wo", "wi", "wi_gate", "norm") or "norm" in parents[-1]:
            return resolve_axes(parents, ndim)

    if name in _NAME_AXES:
        axes = _NAME_AXES[name]
    elif name == "wo":
        if ndim == 3 and "mlp" in parents:
            axes = ("experts", "mlp", "embed")        # MoE down-proj
        elif ndim == 3:
            axes = ("heads", "head_dim", "embed")     # attention out-proj
        elif "mixer" in parents:
            axes = ("ssm_inner", "embed")             # SSD out-proj
        else:
            axes = ("mlp", "embed")                   # dense MLP down-proj
    elif name in ("wi", "wi_gate"):
        axes = (("experts", "embed", "mlp") if ndim == 3
                else ("embed", "mlp"))
    elif name == "norm" and "mixer" in parents:
        axes = ("ssm_inner",)                         # SSD gated-norm scale
    elif "norm" in name:
        axes = ("norm",)
    else:
        axes = (None,) * ndim
    if len(axes) != ndim:
        raise ValueError(f"{'.'.join(keys)}: axes {axes} for {ndim} dims")
    return tuple(axes)


# ---------------------------------------------------------------------------
# Trees: dicts, lists and tuples of tensors, addressed by dotted paths
# ---------------------------------------------------------------------------


def tree_items(tree, prefix: str = ""):
    """``(dotted path, leaf)`` for every tensor of ``tree``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def tree_map_with_path(fn, tree, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(dotted path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def tree_logical_axes(tree) -> Any:
    """The resolved logical-axes tree (for tests and debugging)."""
    return tree_map_with_path(lambda p, x: resolve_axes(p, x.dim()), tree)


def tree_shardings(rules: ShardingRules, tree, device_mesh) -> Any:
    """The DTensor placements of every leaf on ``device_mesh``."""
    return tree_map_with_path(
        lambda p, x: rules.placements_for(resolve_axes(p, x.dim()), x.shape,
                                          device_mesh), tree)


def shard_tree(tree, rules: ShardingRules, device_mesh) -> Any:
    """``tree`` as DTensors in the rules' layout.  Every rank holds the
    same whole tensors (weights drawn from one seed, zero states) and keeps
    its own shard of each; no data moves."""
    from torch.distributed.tensor import distribute_tensor

    def put(path, x):
        placements = rules.placements_for(resolve_axes(path, x.dim()),
                                          x.shape, device_mesh)
        return distribute_tensor(x.detach(), device_mesh, placements,
                                 src_data_rank=None)
    return tree_map_with_path(put, tree)


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree of DTensors (plain tensors
    count whole)."""
    total = 0
    for _, x in tree_items(tree):
        local = x.to_local() if is_dtensor(x) else x
        total += local.numel() * local.element_size()
    return total


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def logical_constraint(rules: ShardingRules, x, logical_axes):
    """A DTensor redistributed to the rules' layout for ``logical_axes``;
    a plain tensor unchanged (as the reference's is a no-op outside a
    mesh)."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, rules.placements_for(logical_axes, x.shape,
                                                     mesh))


# ---------------------------------------------------------------------------
# Compute on the local "model" shards
#
# A layer reads each weight gathered over every mesh dim but "model" (the
# FSDP all-gather over "data"/"pod", as the reference's SPMD program also
# does) and keeps its own "model" shard: the plain tensor it computes on
# is that shard.  Where the rules split a weight over "model", the layer
# computes on its slice of the heads, MLP, vocab, experts or SSM heads and
# crosses between a replicated activation and a sharded one through the
# operators below; where the divisibility fallback replicated it, the
# layer computes it whole, as every rank of the group does.
#
#   copy_to_model      identity forward, all-reduce backward: a replicated
#                      activation entering sharded compute (the input of a
#                      column-parallel product; a replicated weight or
#                      activation read by local heads)
#   reduce_from_model  all-reduce forward, identity backward: partial sums
#                      leaving it (the output of a row-parallel product,
#                      a vocab-parallel lookup or softmax sum)
#   gather_from_model  all-gather forward, this rank's slice backward: a
#                      sharded tensor needed whole by replicated compute
#                      (the MoE router, the last logits a server samples)
#
# Each is one functional collective over the "model" dim of the mesh, so
# ``CommDebugMode`` counts it as the dry run prices it.
# ---------------------------------------------------------------------------

MODEL = "model"


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's piece of a leaf that the rules split over ``"model"``:
    entries ``[start, stop)`` of its tensor dim ``dim``, and ``group``, the
    ``(mesh, mesh dim)`` of the ranks that hold the rest."""
    dim: int
    start: int
    stop: int
    group: tuple


def model_shard(module, leaf: str) -> ModelShard | None:
    """The ``"model"`` shard of ``module``'s parameter ``leaf`` as bound by
    :func:`gather_on_use`, or None where the leaf is whole on every rank
    (an unsharded model, a dim the fallback replicated, a model axis of
    size 1)."""
    x = getattr(module, "_bound", {}).get(leaf)
    if x is None or not is_dtensor(x):
        return None
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    if MODEL not in names:
        return None
    d = names.index(MODEL)
    pl = x.placements[d]
    if not pl.is_shard() or mesh.size(d) == 1:
        return None
    per = x.shape[pl.dim] // mesh.size(d)
    r = mesh.get_local_rank(d)
    return ModelShard(pl.dim, r * per, (r + 1) * per, (mesh, d))


def _wait(x):
    from torch.distributed import _functional_collectives as funcol
    return x.wait() if isinstance(x, funcol.AsyncCollectiveTensor) else x


def _all_reduce(x, op: str, group):
    from torch.distributed import _functional_collectives as funcol
    return _wait(funcol.all_reduce(x.contiguous(), op, group))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        mesh, d = group
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.start = mesh.get_local_rank(d) * ctx.size
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.size), None, None


def copy_to_model(x, shard: ModelShard | None):
    """``x`` entering compute on ``shard``'s pieces (identity; its
    gradient all-reduced over the group).  Identity without a shard."""
    return x if shard is None else _CopyToModel.apply(x, shard.group)


def reduce_from_model(x, shard: ModelShard | None):
    """``x`` summed over ``shard``'s group (its gradient passes as it
    is).  Identity without a shard."""
    return x if shard is None else _ReduceFromModel.apply(x, shard.group)


def gather_from_model(x, shard: ModelShard | None, dim: int | None = None):
    """``x``, this rank's piece of ``shard``, gathered whole along ``dim``
    (``shard.dim`` by default); its gradient is this rank's slice."""
    if shard is None:
        return x
    dim = shard.dim if dim is None else dim % x.dim()
    return _GatherFromModel.apply(x, dim, shard.group)


def max_over_model(x, shard: ModelShard | None):
    """The elementwise max of ``x`` over ``shard``'s group, outside
    autograd (a softmax's shift)."""
    return x if shard is None else _all_reduce(x.detach(), "max",
                                               shard.group)


# ---------------------------------------------------------------------------
# The sequence over "model"
#
# Under sequence parallelism (``rcfg.seq_parallel`` where the rules split
# ``act_seq``) the residual stream between layers holds this rank's
# positions ``[B, S/n, d]``: the norms, residual adds and attention's
# queries run on them.  A layer that computes on its "model" shard of the
# weights (the MLP, the experts, the SSM heads, the vocab) reads the whole
# sequence and leaves partial sums of it:
#
#   gather_seq   all-gather forward, reduce-scatter backward: local
#                positions entering sharded compute on the whole sequence
#                (each rank's gradient is a partial sum); also a weight's
#                shard read whole by compute on local positions
#   scatter_seq  reduce-scatter forward, all-gather backward: partial sums
#                of the whole sequence onto each rank's positions
#   split_seq    this rank's positions forward, all-gather backward: a
#                whole tensor every rank computed alike, to local positions
#
# ``gather_from_model`` (all-gather, this rank's slice backward) takes
# local positions into compute that every rank repeats on the whole
# sequence, ``copy_to_model`` a whole tensor into compute on local
# positions (a weight the fallback left whole: its gradient is a partial
# sum over the positions), and ``once_over_model`` marks the part of a
# ``gather_seq`` result that replicated compute reads.  A ``ModelShard``
# whose ``dim`` is the sequence's describes this rank's positions.
# ---------------------------------------------------------------------------


def _gloo_cuda(x, group) -> bool:
    """gloo on CUDA tensors: the functional all-gather kills the process
    (signal 11 under torch 2.11; ``tools/gloo_probe.py`` lists what
    runs), so the gather takes the all-reduce form below, which gives the
    same values."""
    import torch.distributed as dist
    mesh, d = group
    return x.is_cuda and dist.get_backend(mesh.get_group(d)) == "gloo"


def _all_gather(x, dim: int, group):
    from torch.distributed import _functional_collectives as funcol
    mesh, d = group
    if _gloo_cuda(x, group):
        shape = list(x.shape)
        shape[dim] *= mesh.size(d)
        whole = x.new_zeros(shape)
        whole.narrow(dim, mesh.get_local_rank(d) * x.shape[dim],
                     x.shape[dim]).copy_(x)
        return _all_reduce(whole, "sum", group)
    return _wait(funcol.all_gather_tensor(x.contiguous(), dim, group))


def _reduce_scatter(x, dim: int, group):
    from torch.distributed import _functional_collectives as funcol
    return _wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum", dim,
                                              group))


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, start, stop, group):
        ctx.dim, ctx.group = dim, group
        return x.narrow(dim, start, stop - start)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None, None, None


class _OnceOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        mesh, d = group
        ctx.first = mesh.get_local_rank(d) == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def gather_seq(x, shard: ModelShard | None):
    """``x``, this rank's piece along ``shard.dim``, all-gathered whole;
    its gradient, a partial sum on every rank, reduce-scattered back.
    Identity without a shard."""
    if shard is None:
        return x
    return _GatherSeq.apply(x, shard.dim % x.dim(), shard.group)


def scatter_seq(x, shard: ModelShard | None):
    """Partial sums ``x`` of the whole sequence summed over ``shard``'s
    group onto this rank's positions (its gradient all-gathered).
    Identity without a shard."""
    if shard is None:
        return x
    return _ScatterSeq.apply(x, shard.dim % x.dim(), shard.group)


def split_seq(x, shard: ModelShard | None):
    """This rank's positions of ``x`` (whole and the same on every rank
    of the group); its gradient all-gathered.  Identity without a
    shard."""
    if shard is None:
        return x
    return _SplitSeq.apply(x, shard.dim % x.dim(), shard.start, shard.stop,
                           shard.group)


def once_over_model(x, shard: ModelShard | None):
    """``x`` (a :func:`gather_seq` result) read by compute that every rank
    of the group repeats: its gradient, the same on every rank, is kept on
    the group's first rank only, so the reduce-scatter of ``gather_seq``
    counts it once.  Identity without a shard."""
    return x if shard is None else _OnceOverModel.apply(x, shard.group)


def model_group(module) -> tuple | None:
    """``(mesh, mesh dim)`` of the ``"model"`` group of ``module``'s bound
    leaves (:func:`gather_on_use`), whether or not the rules split them;
    None without a mesh or on a model axis of one."""
    for x in getattr(module, "_bound", {}).values():
        if is_dtensor(x):
            mesh = x.device_mesh
            names = list(mesh.mesh_dim_names)
            if MODEL in names and mesh.size(names.index(MODEL)) > 1:
                return mesh, names.index(MODEL)
            return None
    return None


def model_piece(axes, shape, group, rules: ShardingRules | None = None):
    """``(dim, start, stop)``: the entries of dim ``dim`` that this rank
    of ``group`` holds of a tensor of ``shape`` and logical ``axes`` where
    the rules give ``"model"`` to that dim (the divisibility fallback and
    the used-axis rule applied), else None.  Only the ``"model"`` axis is
    looked at: a batch dim is split over the others by the caller."""
    if group is None:
        return None
    mesh, d = group
    n = mesh.size(d)
    spec = (rules or ShardingRules(TRAIN_RULES)).spec_for(
        axes, shape, _Sizes({MODEL: n}))
    for dim, entry in enumerate(spec):
        if entry is not None and MODEL in (entry if isinstance(entry, tuple)
                                           else (entry,)):
            per = shape[dim] // n
            r = mesh.get_local_rank(d)
            return dim, r * per, (r + 1) * per
    return None


class _Sizes:
    """A mesh seen only through its axis sizes (``mesh_shape``)."""

    def __init__(self, shape: dict):
        self.shape = shape


def seq_shard(module, length: int, name: str = "act_seq", dim: int = 1,
              rules: ShardingRules | None = None) -> ModelShard | None:
    """This rank's positions ``[start, stop)`` of a sequence of ``length``
    under the rules' ``name`` (``"act_seq"`` or ``"cache_seq"``) on the
    mesh of ``module``'s bound leaves, as a :class:`ModelShard` of tensor
    dim ``dim``; None without a mesh or where the divisibility fallback
    keeps the sequence whole."""
    group = model_group(module)
    piece = model_piece((name,), (length,), group, rules)
    if piece is None:
        return None
    return ModelShard(dim, piece[1], piece[2], group)


def gather_local(x, grad_placements):
    """A DTensor gathered over every mesh dim but ``"model"`` into a plain
    tensor, this rank's ``"model"`` shard (a plain tensor passes).  Its
    gradient flows back as ``grad_placements`` and autograd reduces it
    into ``x``'s own layout (a reduce-scatter over ``"data"``)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    keep = [p if n == MODEL else Replicate()
            for n, p in zip(mesh.mesh_dim_names, x.placements)]
    return x.redistribute(mesh, keep).to_local(
        grad_placements=grad_placements(x))


def leaf_grad_placements(x) -> list:
    """The placements of a leaf's local gradient: ``Partial()`` on the
    batch dims of size > 1 (a local batch's gradient is a partial sum over
    them), the leaf's own placement on ``"model"`` (a shard's gradient is
    its own; a replicated leaf's is whole and the same on every rank of
    the group), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = x.device_mesh
    out = []
    for d, name in enumerate(mesh.mesh_dim_names):
        if name == MODEL:
            out.append(x.placements[d])
        elif name in BATCH_AXES and mesh.size(d) > 1:
            out.append(Partial())
        else:
            out.append(Replicate())
    return out


_GATHERING: dict = {}


def _gathering_class(cls, leaves: tuple):
    """A subclass of ``cls`` whose attributes ``leaves`` read the bound
    tensors through :func:`gather_local` (plain properties: no module is
    called, so module hooks such as ``CommDebugMode``'s see nothing)."""
    key = (cls, leaves)
    if key not in _GATHERING:
        def prop(leaf):
            return property(lambda self: gather_local(
                self._bound[leaf], leaf_grad_placements))
        _GATHERING[key] = type(f"Gathering{cls.__name__}", (cls,),
                               {leaf: prop(leaf) for leaf in leaves})
    return _GATHERING[key]


def gather_on_use(model: torch.nn.Module) -> dict:
    """Make every parameter of ``model`` (a skeleton, e.g. on ``meta``)
    read a bound DTensor through :func:`gather_local` on each access: its
    ``"model"`` shard, gathered over the other mesh dims (again in remat's
    recomputation).  Returns the slots ``{name: (module, leaf)}`` for
    :func:`bind`; :func:`model_shard` reads a bound leaf's shard."""
    slots = {}
    for mod_name, mod in list(model.named_modules()):
        leaves = tuple(mod._parameters)
        if not leaves:
            continue
        mod._bound = dict(mod._parameters)
        for leaf in leaves:
            del mod._parameters[leaf]
            slots[f"{mod_name}.{leaf}" if mod_name else leaf] = (mod, leaf)
        mod.__class__ = _gathering_class(type(mod), leaves)
    return slots


def bind(slots: dict, params: dict):
    """Point each slot of :func:`gather_on_use` at ``params[name]``."""
    if slots.keys() != params.keys():
        raise ValueError(f"parameters {sorted(set(slots) ^ set(params))} "
                         f"differ from the model's")
    for name, (mod, leaf) in slots.items():
        mod._bound[leaf] = params[name]


def batch_coordinate(device_mesh) -> tuple[int, int]:
    """(this rank's index, the count) of batch shards: pod-major over the
    mesh's batch dims; ranks of one ``"model"`` group share an index."""
    coord = device_mesh.get_coordinate()
    idx, n = 0, 1
    for d, name in enumerate(device_mesh.mesh_dim_names):
        if name in BATCH_AXES:
            size = device_mesh.size(d)
            idx, n = idx * size + coord[d], n * size
    return idx, n


def batch_shard(batch: dict, device_mesh) -> dict:
    """This rank's rows of a global batch (a dict of tensors or arrays
    with the batch leading); 0-d entries pass whole, and so does a batch
    the shards do not divide (the rules' divisibility fallback: every
    shard computes it)."""
    idx, n = batch_coordinate(device_mesh)

    def rows(x):
        if x.ndim == 0 or x.shape[0] % n:
            return x
        per = x.shape[0] // n
        return x[idx * per:(idx + 1) * per]
    return {k: rows(x) for k, x in batch.items()}


def all_reduce_over(x: torch.Tensor, device_mesh, names) -> torch.Tensor:
    """``x`` summed over the mesh dims in ``names`` (one functional
    all-reduce per dim of size > 1, so ``CommDebugMode`` sees each)."""
    from torch.distributed import _functional_collectives as funcol
    for d, name in enumerate(device_mesh.mesh_dim_names):
        if name in names and device_mesh.size(d) > 1:
            x = funcol.all_reduce(x, "sum", (device_mesh, d))
    return x
