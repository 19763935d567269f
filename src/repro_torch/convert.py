"""Carry state from the JAX package into the port.

The JAX package's parameters reach this module as NumPy (``jax.tree.map(
np.asarray, params)``), so the port never imports JAX.  The tests use these
two functions to make both packages compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import default_device
from repro_torch.core.retrieval import VectorStore


def predictor_params_from_numpy(tree, device=None):
    """A predictor parameter tree of NumPy arrays (JAX layout: ``wqkv``
    (d, 3, h, hd), ``wo`` (h, hd, d)) -> the same tree of float32
    tensors."""
    device = default_device(device)
    if isinstance(tree, dict):
        return {k: predictor_params_from_numpy(v, device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [predictor_params_from_numpy(v, device) for v in tree]
    # a copy: arrays fetched from JAX are read-only
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def vector_store_from_numpy(emb, labels, size: int, device=None
                            ) -> VectorStore:
    """Rebuild a :class:`VectorStore` around given (capacity, d) embedding
    and (capacity, L) label buffers whose first ``size`` rows are live."""
    emb = np.array(emb, np.float32)          # copies: JAX arrays are
    labels = np.array(labels, np.float32)    # read-only
    vs = VectorStore(emb.shape[1], labels.shape[1], capacity=emb.shape[0],
                     device=device)
    vs.append(emb[:size], labels[:size])
    return vs
