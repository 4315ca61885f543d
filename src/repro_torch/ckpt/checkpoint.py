"""Atomic, async training checkpoints in the reference's format.

The counterpart of ``repro.ckpt.checkpoint``; a checkpoint written by
either package restores in the other. One directory per step:

  arrays.npz   the tree's leaves, each keyed by its path as
               ``jax.tree_util.keystr`` writes it (``[0]['blocks']['attn']
               ['wq']``, ``[1].step``, ``[1].m['embed'].q``)
  meta.json    step, time, and per leaf its shape, dtype and crc32
  COMMIT       written last; a directory without it is never restored

bfloat16 has no numpy dtype of its own. On the host a bf16 leaf is its
bits in a 2-byte void array (``BF16_HOST``), the form the reference's
``np.savez`` writes ``ml_dtypes.bfloat16`` arrays in, with ``"dtype":
"bfloat16"`` in meta.json; ``restore`` reads such a leaf back by that
dtype, bit for bit. ``host_tensor`` turns a host array (a bf16 one too)
into a tensor sharing its memory.

A tree is nested dicts (keys in sorted order, as ``jax.tree_util``
flattens them), tuples and lists, and named tuples (their fields, as
attributes), with numpy arrays or tensors as leaves; ``None`` holds no
leaf. ``convert.train_tree`` turns the port's (params, optimizer state)
into the reference's tree, block weights stacked on a leading layer axis.

Elasticity: leaves are stored whole, so ``restore`` with ``shardings``
(a matching tree of ``dist.sharding.NamedSharding``) places each leaf on
its mesh as a DTensor: a checkpoint of one mesh restores onto another.

Atomicity: the step is written into ``<dir>.tmp``, every file is fsynced
and then the directory, and ``os.replace`` renames it into place: the
rename is the commit. Integrity: ``restore`` checks every leaf's crc32
before it places any, and names the corrupt leaf. Async:
``CheckpointManager.save_async`` copies the tree to host memory at once
and writes it on a background thread; ``wait`` joins it and re-raises its
error.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.retrieval.base import fsync_dir, leaf_crc32

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """A leaf of a ``restore`` template that holds no data: the shape and
    dtype the restored numpy array must have."""
    shape: Tuple[int, ...]
    dtype: np.dtype


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree: PyTree, path: str = ""
                      ) -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) in ``jax.tree_util`` flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{path}[{k!r}]")
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from leaves_with_paths(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from leaves_with_paths(x, f"{path}[{i}]")
    else:
        yield path, tree


def map_with_paths(fn: Callable[[str, Any], Any], tree: PyTree,
                   path: str = "") -> PyTree:
    """The tree with each leaf replaced by ``fn(keystr, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_paths(fn, getattr(tree, f),
                                           f"{path}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_paths(fn, x, f"{path}[{i}]")
                          for i, x in enumerate(tree))
    return fn(path, tree)


# a bfloat16 leaf's bits on the host
BF16_HOST = np.dtype("V2")


def is_bf16_host(dtype) -> bool:
    """A host dtype that holds bfloat16 bits: ``BF16_HOST`` or
    ``ml_dtypes.bfloat16`` (both 2-byte voids to numpy)."""
    dtype = np.dtype(dtype)
    return dtype.kind == "V" and dtype.itemsize == 2


def numpy_dtype(dtype) -> np.dtype:
    """A torch or numpy dtype as a numpy dtype (bfloat16: ``BF16_HOST``)."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return BF16_HOST
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A contiguous host array as a CPU tensor sharing its memory; bf16
    bits become a bfloat16 tensor."""
    if is_bf16_host(arr.dtype):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a tensor is copied off its device; a
    bfloat16 one as its bits, ``BF16_HOST``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(BF16_HOST)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _meta_dtype(arr: np.ndarray) -> str:
    return "bfloat16" if is_bf16_host(arr.dtype) else str(arr.dtype)


def _cast_host(arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """A host array as ``dtype`` (bf16 bits on either side go through
    torch's bfloat16)."""
    if arr.dtype == dtype or (is_bf16_host(arr.dtype)
                              and is_bf16_host(dtype)):
        return arr
    if not (is_bf16_host(arr.dtype) or is_bf16_host(dtype)):
        return arr.astype(dtype, copy=False)
    t = host_tensor(np.require(arr, requirements="C"))
    if is_bf16_host(dtype):
        return to_host(t.to(torch.bfloat16))
    return t.float().numpy().astype(dtype, copy=False)


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    return {k: to_host(v) for k, v in leaves_with_paths(tree)}


def _write_fsync(path: str, write_fn) -> None:
    """Write via ``write_fn(f)``, then flush and fsync before closing: a
    COMMIT never reaches the disk ahead of the data it commits."""
    with open(path, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())


def save(directory: str, step: int, tree: PyTree) -> str:
    """Synchronous atomic save of ``tree`` as step ``step`` under
    ``directory``. Returns the committed path."""
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays = _flatten(tree)
    meta = {
        "step": step,
        "time": time.time(),
        "leaves": {k: {"shape": list(v.shape), "dtype": _meta_dtype(v),
                       "crc32": leaf_crc32(v)}
                   for k, v in arrays.items()},
    }
    arrays = {k: v.view(BF16_HOST) if is_bf16_host(v.dtype) else v
              for k, v in arrays.items()}
    _write_fsync(os.path.join(tmp, "arrays.npz"),
                 lambda f: np.savez(f, **arrays))
    _write_fsync(os.path.join(tmp, "meta.json"),
                 lambda f: f.write(json.dumps(meta).encode()))
    _write_fsync(os.path.join(tmp, "COMMIT"), lambda f: f.write(b"ok"))
    fsync_dir(tmp)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    fsync_dir(directory)
    return path


def restore(path: str, template: PyTree,
            shardings: Optional[PyTree] = None) -> PyTree:
    """Load the checkpoint at ``path`` into the structure of ``template``.

    Each template leaf gives the shape the stored array must have and the
    dtype it is cast to: a tensor leaf is restored as a tensor on that
    tensor's device, an array or ``ArraySpec`` leaf as a numpy array. A
    leaf stored as bfloat16 (meta.json's dtype) is read as its bits.
    ``shardings``, a tree matching ``template`` with a
    ``dist.sharding.NamedSharding`` (or None) per leaf, places each leaf
    on its mesh as a DTensor instead (every rank reads the file).
    Every leaf's crc32 is checked before any is placed; a mismatch names
    the leaf."""
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"uncommitted/corrupt checkpoint: {path}")
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    for key, arr in arrays.items():
        info = meta.get("leaves", {}).get(key, {})
        if info.get("dtype") == "bfloat16":
            arrays[key] = arr = arr.view(BF16_HOST)
        want = info.get("crc32")
        if want is None:
            continue  # a checkpoint without crc32: nothing to verify
        got = leaf_crc32(arr)
        if got != int(want):
            raise ValueError(
                f"checkpoint {path!r}: checksum mismatch on leaf {key!r} "
                f"(crc32 {got:#010x} != stored {int(want):#010x}) — "
                "corrupt; restore an earlier committed step")
    placed = (dict(leaves_with_paths(shardings)) if shardings is not None
              else {})

    def place(key, leaf):
        if key not in arrays:
            raise KeyError(f"checkpoint {path!r} has no leaf {key!r}")
        arr = arrays[key]
        expect = tuple(leaf.shape)
        if tuple(arr.shape) != expect:
            raise ValueError(f"shape mismatch at {key}: "
                             f"ckpt {arr.shape} vs template {expect}")
        arr = np.require(_cast_host(arr, numpy_dtype(leaf.dtype)),
                         requirements="C")
        sharding = placed.get(key)
        if sharding is not None:
            from repro_torch.dist.sharding import distribute, mesh_device
            return distribute(host_tensor(arr).to(mesh_device(sharding.mesh)),
                              sharding)
        if isinstance(leaf, torch.Tensor):
            return host_tensor(arr).to(leaf.device)
        return arr

    return map_with_paths(place, template)


def latest_step(directory: str) -> Optional[int]:
    """The highest committed step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "COMMIT")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def checkpoint_bytes(path: str) -> int:
    """The bytes of a checkpoint directory's files."""
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; async writes; auto-resume.
    ``last_save`` records the latest completed save: its step, path,
    bytes and seconds (the write, fsyncs and rename; for ``save_async``
    the background part)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_save: Optional[Dict[str, Any]] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _save_and_gc(self, step: int, tree: PyTree):
        t0 = time.perf_counter()
        path = save(self.directory, step, tree)
        self.last_save = {"step": step, "path": path,
                          "bytes": checkpoint_bytes(path),
                          "seconds": time.perf_counter() - t0}
        self._gc()

    def save_async(self, step: int, tree: PyTree):
        self.wait()
        # snapshot to host memory now: the next step replaces the tensors
        # (a CPU tensor's array would share its memory, so it is copied)
        host_tree = map_with_paths(
            lambda _, x: (to_host(x).copy() if isinstance(x, torch.Tensor)
                          and x.device.type == "cpu" else to_host(x)), tree)

        def work():
            try:
                self._save_and_gc(step, host_tree)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: PyTree):
        self.wait()
        self._save_and_gc(step, tree)

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.directory, n, "COMMIT")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, template: PyTree,
                       shardings: Optional[PyTree] = None
                       ) -> Optional[tuple]:
        """(step, tree) of the latest committed checkpoint, or None;
        ``shardings`` as ``restore`` takes them."""
        step = latest_step(self.directory)
        if step is None:
            return None
        path = os.path.join(self.directory, f"step_{step:08d}")
        return step, restore(path, template, shardings)
