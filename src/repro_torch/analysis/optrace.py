"""The op recorder: the port's counterpart of ``jax.make_jaxpr``.

:class:`OpRecorder` is a ``TorchDispatchMode``.  Inside ``with
OpRecorder() as rec:`` every op that reaches the dispatcher runs eagerly,
on its inputs' device, and leaves one :class:`OpRecord`: its name and
tags, its tensor inputs and outputs, the arguments its schema marks as
written, and whether it ran inside
:func:`repro_torch.core.commit.commit_scope`.  The port's four kernels
are dispatched ops (``repro_torch::coarse_commit``,
``::fused_route_commit``, ``::bucket_count``, ``::ssd_chunk``), so a
launch is one record on the card and on the CPU alike, and nothing
inside it is recorded.

A tensor is named by its storage: views share their base's key, and
:meth:`OpRecorder.key` gives the key of a tensor the caller holds (the
round state a pass seeds its chain with).  Keys are held through weak
references to the storages, so a storage that dies takes its key with
it and a later allocation at the same address gets a new one; a data
pointer would not do, as the caching allocator reuses addresses.

Eager recording runs the function: loops and branches appear as the
iterations and the branch that ran, so there is no ``while``/``scan``/
``cond`` walk.  The passes over a record are
:mod:`repro_torch.analysis.waverace` and :mod:`repro_torch.runtime.flops`.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only

from repro_torch.core.commit import commit_scope


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """A recorded tensor: its storage key, shape, dtype and bytes."""
    key: int
    shape: tuple
    dtype: torch.dtype

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched op.

    name:    the packet name, ``"aten::scatter_reduce_"`` or
             ``"repro_torch::coarse_commit"``;
    tags:    the op's ``torch.Tag`` set (``pointwise``, ``inplace_view``…);
    view:    the op returns a view of an input (``func.is_view``);
    args:    positional arguments, tensors as :class:`TensorMeta`;
    inputs:  every tensor argument, keyword ones too, in order;
    outputs: every tensor the op returned;
    writes:  the arguments its schema marks as written (in-place ops);
    scope:   the :func:`~repro_torch.core.commit.commit_scope` entry it
             ran in (0 = outside every scope)."""
    name: str
    tags: frozenset
    view: bool
    args: tuple
    inputs: tuple
    outputs: tuple
    writes: tuple
    scope: int

    @property
    def scoped(self) -> bool:
        return self.scope != 0


# state writes: op names' prefixes after the namespace (``scatter*``,
# ``index_put*``, ``index_add*``, ``index_copy*``, ``index_reduce*``,
# ``masked_scatter*``, ``put*``, in place or not)
SCATTER_PREFIXES = ("scatter", "index_put", "_index_put", "index_add",
                    "index_copy", "index_reduce", "masked_scatter", "put")


def is_scatter(name: str) -> bool:
    """Is the op ``name`` (``"aten::index_put_"``) a scatter-class write?"""
    return name.partition("::")[2].startswith(SCATTER_PREFIXES)


class OpRecorder(TorchDispatchMode):
    """Record every op run inside ``with`` into :attr:`records`."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []
        self._keys: dict[int, tuple[weakref.ref, int]] = {}
        self._next = 1

    def key(self, t: torch.Tensor) -> int:
        """The key of ``t``'s storage, assigned at first sight."""
        s = t.untyped_storage()
        entry = self._keys.get(id(s))
        if entry is not None and entry[0]() is s:
            return entry[1]
        k = self._next
        self._next += 1
        sid = id(s)

        def forget(ref, sid=sid, keys=self._keys):
            if keys.get(sid, (None,))[0] is ref:
                del keys[sid]
        self._keys[sid] = (weakref.ref(s, forget), k)
        return k

    def meta(self, t: torch.Tensor) -> TensorMeta:
        return TensorMeta(self.key(t), tuple(t.shape), t.dtype)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        scope = commit_scope()
        schema = func._schema
        writes = []
        for i, arg in enumerate(schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            writes += [t for t in tree_flatten(val)[0]
                       if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self.records.append(OpRecord(
            name=schema.name, tags=frozenset(func.tags), view=func.is_view,
            args=tree_map_only(torch.Tensor, self.meta, tuple(args)),
            inputs=tuple(self.meta(t) for t in ins),
            outputs=tuple(self.meta(t) for t in outs),
            writes=tuple(self.meta(t) for t in writes),
            scope=scope.entries if scope.depth else 0))
        return out


def record(fn, *args, **kwargs) -> tuple[Any, OpRecorder]:
    """``(fn(*args, **kwargs), recorder)`` with every op of the call
    recorded."""
    rec = OpRecorder()
    with rec:
        out = fn(*args, **kwargs)
    return out, rec
