"""Live device bytes of one call, counted op by op with no allocation.

The port's counterpart of the reference's ``compiled.memory_analysis()``
(``repro.launch.dryrun.memory_record``): where XLA plans a compiled
program's buffers, :class:`LiveBytes` watches an eager call.  It is a
``TorchDispatchMode`` that adds an untyped storage's ``nbytes()`` when an
op first returns it and takes them off when the storage is freed (a
weak reference's callback on the storage), keeping the highest total.  It
reads only shapes, dtypes and storage identity, so it counts fake tensors
(``FakeTensorMode``, no allocation) and real ones alike, and gives both
the same bytes.

* Views and in-place ops return a storage already seen and add nothing.
* Modes follow autograd's thread state, so the ops of a backward and of
  ``torch.utils.checkpoint``'s recomputation are counted as they run.
* A DTensor (any traceable wrapper subclass) counts the storages of its
  inner tensors: this rank's local shard, never the global shape.  A mode
  above DTensor sees DTensor-level outputs and the functional collectives
  beneath them, so the weights that ``gather_local`` gathers on each use
  are counted.
* Tensors made before the call are not the mode's: :meth:`LiveBytes.known`
  marks their storages so that a view of one adds nothing, and
  :func:`memory_record` counts them as the arguments.
* Inside a dispatched op (``torch.ops.repro_torch.*``) the mode sees only
  the op's outputs.  On the LM paths the SSD chunk and bucket count
  kernels allocate nothing but their outputs (``kernels/ssd_chunk.py``,
  ``kernels/coalesce.py``); the commit kernels' ``scratch``
  (``kernels/coarse_commit.py``) is off the dry run's path.  A kernel
  that gains a workspace must return it from its op, or be counted here
  by hand, for the count to hold.
* An op's own scratch (a sort's temporary storage, cuBLAS's workspace)
  is not an output and is not seen; the card's allocator counts it.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          is_traceable_wrapper_subclass)
from torch.utils._pytree import tree_flatten

FIELDS = ("argument_size_in_bytes", "output_size_in_bytes",
          "alias_size_in_bytes", "temp_size_in_bytes",
          "peak_memory_in_bytes")


def _inner(t) -> list:
    """The inner tensors of a wrapper subclass (a DTensor's local shard;
    its flatten names may also list its mesh)."""
    inner = (getattr(t, n) for n in t.__tensor_flatten__()[0])
    return [x for x in inner if isinstance(x, torch.Tensor)]


def storages(tree):
    """The untyped storages of every tensor in ``tree`` (a wrapper
    subclass's inner tensors; each storage once), by ``id``."""
    out = {}
    todo = [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]
    while todo:     # no recursive closure: its cycle would keep them alive
        t = todo.pop()
        if is_traceable_wrapper_subclass(t):
            todo += _inner(t)
        elif t.device.type != "meta":
            s = t.untyped_storage()
            out.setdefault(id(s), s)
    return out


class LiveBytes(TorchDispatchMode):
    """Inside ``with``: :attr:`live`, the bytes of the storages ops have
    returned that are still alive, and :attr:`peak`, their highest total.
    Storages marked by :meth:`known` (the arguments) are not counted."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen: dict[int, weakref.ref] = {}

    def _see(self, s, count: bool):
        sid = id(s)
        ref = self._seen.get(sid)
        if ref is not None and ref() is s:
            return
        n = int(s.nbytes()) if count else 0

        def gone(_, sid=sid, n=n, seen=self._seen):
            if seen.get(sid) is ref_s:
                del seen[sid]
            self.live -= n
        ref_s = weakref.ref(s, gone)
        self._seen[sid] = ref_s
        self.live += n
        self.peak = max(self.peak, self.live)

    def known(self, tree):
        """Mark the storages of ``tree`` as made before the call."""
        for s in storages(tree).values():
            self._see(s, count=False)
        return self

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for s in storages(out).values():
            self._see(s, count=True)
        return out


def memory_record(arguments: int, known, outputs, counter: LiveBytes
                  ) -> dict:
    """The reference's ``memory_record`` fields, in bytes a device, of a
    call counted by ``counter``: ``arguments``, the bytes this rank holds
    on entry; ``known``, the tree of tensors made before the call;
    ``outputs``, what the call returned.  An output whose storage is an
    argument's (an in-place update) is an alias; the temporaries are the
    peak less the arguments, less the outputs that are not aliases."""
    args = storages(known)
    outs = storages(outputs)
    output = sum(int(s.nbytes()) for s in outs.values())
    alias = sum(int(s.nbytes()) for k, s in outs.items() if k in args)
    peak = arguments + counter.peak
    return dict(zip(FIELDS, (arguments, output, alias,
                             peak - arguments - (output - alias), peak)))
