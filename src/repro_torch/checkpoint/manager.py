"""Checkpointing: atomic, async-capable, in the JAX package's on-disk format.

Port of ``repro.checkpoint.manager`` (``save``, ``restore``,
``read_manifest``, ``latest_step``, ``AsyncWriter``,
``elastic_pod_resize``). One ``step_<N>/``
directory holds ``arrays.npz`` (leaves keyed by their tree paths) and
``manifest.json`` (``step``, ``keys``, ``shapes``, ``dtypes``, ``extra``).
Writes go to ``<dir>.tmp`` and are renamed atomically, so a crash mid-write
never corrupts the latest checkpoint.

Trees of dataclasses and dicts are walked explicitly: a dataclass field is
the path part ``.name``, a dict key ``['key']`` (keys in sorted order), and
``None`` holds no leaf -- the paths and order ``jax.tree_util`` gives the
same structures, so a checkpoint written by either package restores in the
other. Leaves are
tensors (any device), numpy arrays and Python or numpy scalars. bfloat16 is
stored as its uint16 bits with its true dtype in the manifest, as the JAX
package stores it.

``AsyncWriter.submit`` takes a host tree, copied by the caller on its own
thread and stream (the consistency point; ``schedule.host_state`` does it
for a ``SimState``), and refuses a device tensor: its worker thread only
serialises host arrays.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

__all__ = [
    "save",
    "restore",
    "read_manifest",
    "latest_step",
    "AsyncWriter",
    "elastic_pod_resize",
]


def _children(tree) -> list[tuple[str, Any]] | None:
    """``(path part, child)`` pairs of an inner node; None for a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    return None


def _leaves(tree, path: tuple[str, ...] = ()):
    """``(key, leaf)`` in tree order; the key joins the path parts by ``/``."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield "/".join(path), tree
        return
    for part, child in kids:
        yield from _leaves(child, path + (part,))


def _rebuild(tree, fn, path: tuple[str, ...] = ()):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn("/".join(path), tree)
    new = {part: _rebuild(child, fn, path + (part,)) for part, child in kids}
    if isinstance(tree, dict):
        return {k: new[f"[{k!r}]"] for k in tree}
    return dataclasses.replace(tree, **{f.name: new[f".{f.name}"]
                                        for f in dataclasses.fields(tree)})


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """``(array as stored, true dtype name)`` of a leaf (a device tensor is
    copied to the host first)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_str: str, like, device):
    """The stored ``arr`` as a leaf of ``like``'s kind and dtype; tensors go
    straight to ``device`` (``like``'s device when None)."""
    if isinstance(like, torch.Tensor):
        # (ascontiguousarray makes a 0-d array 1-d: the reshape keeps scalars 0-d)
        if dtype_str == "bfloat16":
            host = torch.from_numpy(
                np.ascontiguousarray(arr).reshape(arr.shape).view(np.int16)).view(torch.bfloat16)
        else:
            want = torch.empty(0, dtype=like.dtype).numpy().dtype
            host = torch.from_numpy(np.ascontiguousarray(arr, dtype=want).reshape(arr.shape))
        return host.to(device=like.device if device is None else device, dtype=like.dtype)
    if isinstance(like, (np.ndarray, np.generic)):
        return np.asarray(arr, dtype=like.dtype)
    return type(like)(arr.item() if arr.ndim == 0 else arr)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def save(directory: str, step: int, tree: Any, *, extra: dict | None = None) -> str:
    """Synchronous atomic save. Returns the checkpoint path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    # A leftover .tmp from a crashed writer must not leak stale files into
    # this write: the atomic rename would promote them with the new arrays.
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "treedef": type(tree).__name__,
        "keys": list(arrays),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": dtypes,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def read_manifest(directory: str, step: int | None = None) -> tuple[dict, int]:
    """Read a checkpoint's manifest without loading its arrays: config
    hashes and window-phase records live in ``manifest['extra']``, so a
    resume can be refused before any state is materialised."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        return json.load(f), step


def restore(directory: str, like: Any, step: int | None = None, *,
            device=None) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (shapes validated, dtypes of
    ``like``). ``like`` may hold meta tensors: each tensor leaf is loaded
    straight onto ``device`` (default: the leaf's own device)."""
    manifest, step = read_manifest(directory, step)
    data = np.load(os.path.join(directory, f"step_{step:08d}", "arrays.npz"))

    def load(key, leaf):
        arr = data[key]
        if tuple(arr.shape) != _shape(leaf):
            raise ValueError(
                f"checkpoint leaf {key}: shape {arr.shape} != expected "
                f"{_shape(leaf)} (use elastic_pod_resize for pod-count changes)")
        return _from_numpy(arr, manifest["dtypes"].get(key, ""), leaf, device)

    return _rebuild(like, load), step


class AsyncWriter:
    """Background checkpoint writer with a bounded queue (backpressure).

    Transient I/O failures (``OSError``) are retried up to ``retries`` times
    with exponential backoff before the error is surfaced on the next
    ``submit``/``close``. ``save_fn`` injects the underlying writer (the
    fault harness in :mod:`repro_torch.core.faults` uses it to exercise the
    retry path deterministically).
    """

    def __init__(
        self,
        directory: str,
        keep: int = 3,
        *,
        retries: int = 3,
        backoff_s: float = 0.05,
        save_fn: Callable[..., str] | None = None,
    ):
        self.directory = directory
        self.keep = keep
        self.retries = retries
        self.backoff_s = backoff_s
        self.retry_count = 0  # total transient failures retried (observability)
        self._save = save_fn or save
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._errors: list[Exception] = []

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, extra = item
            try:
                self._save_with_retry(step, host_tree, extra)
                self._gc()
            except Exception as e:  # surfaced on next submit/close
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _save_with_retry(self, step: int, host_tree: Any, extra) -> None:
        for attempt in range(self.retries + 1):
            try:
                self._save(self.directory, step, host_tree, extra=extra)
                return
            except OSError:
                if attempt == self.retries:
                    raise  # retries exhausted: surface on next submit/close
                self.retry_count += 1
                time.sleep(self.backoff_s * (2 ** attempt))

    def _gc(self) -> None:
        entries = os.listdir(self.directory)
        # Orphaned .tmp dirs are a crashed writer's partial output: this
        # worker writes serially, so none of its own can be in flight here.
        for d in entries:
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)
        steps = sorted(
            int(d.split("_")[1])
            for d in entries
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))

    def submit(self, step: int, host_tree: Any, extra: dict | None = None) -> None:
        """Queue ``host_tree`` (numpy arrays, scalars or CPU tensors the
        caller no longer changes) for writing."""
        if self._errors:
            raise self._errors.pop(0)
        for key, leaf in _leaves(host_tree):
            if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
                raise ValueError(
                    f"AsyncWriter.submit takes a host tree; leaf {key} is on "
                    f"{leaf.device} (copy it to the host on the caller's thread)")
        self._q.put((step, host_tree, extra))

    def close(self) -> None:
        self._q.put(None)
        self._worker.join()
        if self._errors:
            raise self._errors.pop(0)


def elastic_pod_resize(tree_pods: Any, new_n_pods: int) -> Any:
    """Re-target per-pod replicated state to a different pod count.

    Leaves carry a leading [n_pods] axis; resizing averages the replicas in
    f32 (the slow-tier sync point) and re-broadcasts in the leaf's dtype, so
    resuming after a pod loss is semantically one early sync. Takes and
    returns trees of dicts and dataclasses (tensor leaves stay on their
    device; numpy leaves come back as numpy)."""
    def resize(_key, x):
        if isinstance(x, torch.Tensor):
            mean = x.float().mean(dim=0)
            return mean[None].expand((new_n_pods,) + tuple(mean.shape)).to(x.dtype).clone()
        mean = np.asarray(x, dtype=np.float32).mean(axis=0)
        return np.broadcast_to(mean[None], (new_n_pods,) + mean.shape).astype(x.dtype)

    return _rebuild(tree_pods, resize)
