"""Async checkpointing of a training state, in the reference's format.

The port of ``repro.ft.checkpoint``: one ``.npz`` per checkpoint holding
every leaf, keyed by its tree path as ``jax.tree_util.
tree_flatten_with_path`` spells it (``['params']/['segs']/[0]/[0]/['attn']/
['wq']``, ``['opt']/['step']``; a ``QTensor``'s values and scales are its
``[<flat index 0>]`` and ``[<flat index 1>]``), joined with ``/``, plus a
``.json`` manifest (step, keys, shapes, dtypes).  bfloat16 leaves are
stored as their ``uint16`` bits (NumPy has no bfloat16; no ``ml_dtypes``
here), the optimizer's step as an int32 scalar, so a checkpoint written by
either package restores into the other.  The leaves are copied to the host
on the caller's thread; the file is written on a thread of its own, and
only the last ``keep`` checkpoints stay.  ``restore`` places each leaf on
the device and in the dtype of the matching leaf of the tree it is given.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.optim import QTensor


def _paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, object]]:
    """(key, leaf) pairs in the reference's flattening order: dict keys
    sorted, lists in order, a QTensor's ``q`` then ``scale``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths(tree[k], prefix + (f"[{k!r}]",))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _paths(v, prefix + (f"[{i}]",))]
    if isinstance(tree, QTensor):
        return (_paths(tree.q, prefix + ("[<flat index 0>]",))
                + _paths(tree.scale, prefix + ("[<flat index 1>]",)))
    return [("/".join(prefix), tree)]


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_host(leaf) for key, leaf in _paths(tree)}


def _like(arr: np.ndarray, like):
    """The stored array as the leaf ``like`` is: a Python int, or a tensor
    on like's device in like's dtype."""
    if isinstance(like, (int, np.integer)):
        return int(arr)
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    if isinstance(tree, QTensor):
        return QTensor(q=_rebuild(tree.q, it), scale=_rebuild(tree.scale, it))
    return next(it)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}")

    def save(self, step: int, tree, *, blocking: bool = False):
        host = _flatten(tree)           # device->host happens on caller thread

        def _write():
            path = self._path(step)
            np.savez(path + ".npz", **host)
            manifest = {
                "step": step,
                "keys": list(host.keys()),
                "shapes": {k: list(v.shape) for k, v in host.items()},
                "dtypes": {k: str(v.dtype) for k, v in host.items()},
            }
            with open(path + ".json", "w") as f:
                json.dump(manifest, f)
            self._gc()

        self.wait()
        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(self._path(s) + ext)
                except OSError:
                    pass

    def list_steps(self):
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".json"):
                out.append(int(f[5:-5]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, like_tree, *, step: Optional[int] = None):
        """(the checkpoint in the structure of ``like_tree``, its step):
        each leaf on the device and in the dtype of like_tree's leaf at the
        same path (the latest checkpoint unless ``step`` is given)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with np.load(self._path(step) + ".npz") as data:
            leaves = [_like(data[key], like)
                      for key, like in _paths(like_tree)]
        return _rebuild(like_tree, iter(leaves)), step
