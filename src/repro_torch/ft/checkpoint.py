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

Over a mesh of ranks (the counterpart of the reference's sharded save and
its ``restore(..., shardings=)``, the elastic re-mesh): ``save(...,
specs=, mesh=)`` takes each rank's local blocks, gathers them whole on
the host of the mesh's rank 0 alone (``common.gather_tree(...,
to_root=True)``: every other rank sends it the blocks only it holds),
which writes the file an unsharded save writes, and returns on every
rank once it is complete;
``restore(..., specs=, mesh=)`` reads each leaf whole on the host and
keeps this rank's block under its spec on the given mesh
(``common.local_block``), which may differ from the mesh that saved.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.params import gather_tree, local_block, map_state
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


def _specs_like(tree, specs) -> list:
    """``specs``' entry for each leaf of ``tree``, in ``_paths`` order (a
    QTensor's spec holds its ``q``'s and its ``scale``'s)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _specs_like(tree[k],
                                                             specs[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v, sp in zip(tree, specs) for x in _specs_like(v, sp)]
    if isinstance(tree, QTensor):
        return [specs.q, specs.scale]
    return [specs]


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

    def save(self, step: int, tree, *, blocking: bool = False, specs=None,
             mesh=None):
        """Write ``tree`` as checkpoint ``step`` (on a thread of its own
        unless ``blocking``).  With ``specs`` and ``mesh`` (a ``launch.
        mesh.Mesh`` over the ranks), ``tree`` is this rank's local blocks:
        every rank of the mesh calls this, the blocks are gathered whole
        on the mesh's rank 0, which writes the unsharded file, and every
        rank returns once it is complete."""
        sharded = mesh is not None and mesh.size > 1
        if sharded:
            # gathered on rank 0's host, which writes the file; the other
            # ranks only send their blocks
            tree = gather_tree(map_state(lambda t: t.detach().cpu(), tree),
                               specs, mesh, to_root=True)
        # device->host happens on caller thread
        host = _flatten(tree) if tree is not None else {}

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
        if sharded:
            if mesh.rank == 0:
                _write()
            torch.distributed.barrier(group=mesh.group(mesh.axis_names))
        elif blocking:
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

    def restore(self, like_tree, *, step: Optional[int] = None, specs=None,
                mesh=None):
        """(the checkpoint in the structure of ``like_tree``, its step):
        each leaf on the device and in the dtype of like_tree's leaf at the
        same path (the latest checkpoint unless ``step`` is given).  With
        ``specs`` and ``mesh``, each leaf is read whole on the host and
        this rank's block under its spec on ``mesh`` is kept (the elastic
        re-mesh: ``mesh`` need not be the one that saved)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        pairs = _paths(like_tree)
        spec_of = (_specs_like(like_tree, specs) if specs is not None
                   else [None] * len(pairs))
        leaves = []
        with np.load(self._path(step) + ".npz") as data:
            for (key, like), spec in zip(pairs, spec_of):
                if spec is None or not isinstance(like, torch.Tensor):
                    leaves.append(_like(data[key], like))
                    continue
                whole = _like(data[key], torch.empty(
                    (), dtype=like.dtype, device="cpu"))
                leaves.append(local_block(whole, spec, mesh).to(like.device))
        return _rebuild(like_tree, iter(leaves)), step
