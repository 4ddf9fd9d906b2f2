"""The live bytes of one call: the port's counterpart of XLA's
``memory_analysis()`` temp and output bytes.

:class:`LiveBytes` is a ``TorchDispatchMode``. Every op output on the
tracked device (``meta`` in the dry run, ``cpu`` in the tests) whose
storage is new (not one of the op's inputs' storages, and not one it has
already seen) is registered once, keyed by the storage, so views and
in-place ops add nothing. Its ``nbytes()`` joins a live count, and a
``weakref.finalize`` on the storage takes them out again when the last
tensor on it dies (the storage's Python object lives as long as any view
of it): temporaries, and the tensors autograd saves for the backward and
frees during it, leave the count when they go.

Storages that exist when the call starts (parameters, optimizer state,
the batch, a cache, tables, a simulation state) are never counted; nor is
anything on another device (host-side ids and indices in a priced call on
``meta``). What the mode reports:

* ``transient``: the most bytes created inside the call and alive at once;
* ``output``: the bytes created inside the call still alive when it
  returned (its results, and what it left in place of its inputs).

It counts what eager PyTorch allocates through the dispatcher: not the
caching allocator's rounding, not a library's workspace (cuBLAS), not a
kernel's internal scratch that its wrapper does not allocate as a tensor.
Per op it costs one dictionary lookup, and one insert and one finalizer
for each new storage. Stack it with a ``FlopCounterMode`` to price one pass.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["LiveBytes"]


class LiveBytes(TorchDispatchMode):
    """Counts the bytes of the storages created on ``device`` while the
    mode is on: ``live`` now, ``transient`` (their most), and ``output``
    (what was alive when the mode was left)."""

    def __init__(self, device="meta"):
        super().__init__()
        self.device = torch.device(device).type
        self.live = 0
        self.transient = 0
        self.output = 0
        self._seen: dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = None
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or t.device.type != self.device:
                continue
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._seen:
                continue
            if inputs is None:
                inputs = {x.untyped_storage()._cdata
                          for x in tree_leaves((args, kwargs)) if isinstance(x, torch.Tensor)}
            if key in inputs:  # in place, or a view of an input
                continue
            nbytes = storage.nbytes()
            self._seen[key] = nbytes
            self.live += nbytes
            self.transient = max(self.transient, self.live)
            weakref.finalize(storage, self._free, key)
        return out

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key)

    def __exit__(self, *exc):
        self.output = self.live
        return super().__exit__(*exc)
