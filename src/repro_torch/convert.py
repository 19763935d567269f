"""Carry state from the JAX package into the port.

The JAX package's parameters and training states reach this module as
NumPy (``jax.tree.map(np.asarray, params)``), so the port never imports
JAX.  The tests use these functions to make both packages compute the same
function.
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


def predictor_params_to_numpy(tree):
    """The inverse of :func:`predictor_params_from_numpy`: a tree of
    tensors (on any device) -> the same tree of float32 NumPy arrays."""
    if isinstance(tree, dict):
        return {k: predictor_params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [predictor_params_to_numpy(v) for v in tree]
    return tree.detach().to("cpu", torch.float32).numpy()


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


def model_params_from_numpy(cfg, tree, device=None):
    """A ``DecoderLM`` parameter tree of NumPy arrays (the JAX layout:
    ``segs[si][j]`` dicts of stacked ``(count, ...)`` leaves) -> the same
    tree of tensors on ``device``.  In a float32 configuration every leaf
    is float32: the reference declares most leaves bf16 whatever the
    configuration's dtype, and its float32 runs cast that init to float32
    (``common.cast_tree`` on the port's side).  In any other configuration
    each leaf takes the dtype of its declaration (``DecoderLM.decls()``):
    bf16, or float32 for the leaves the reference declares float32
    (hymba's ``w_dt``, ``dt_bias``, ``a_log``, ``d_skip`` and ``beta``, the
    mLSTM's ``w_gates``, the MoE router).  The arrays may arrive as
    float32 either way, which holds bf16 values exactly."""
    from repro_torch.models import build_model
    device = default_device(device)
    f32 = cfg.dtype == torch.float32

    def walk(node, decl):
        if isinstance(node, dict):
            return {k: walk(v, decl[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, d) for v, d in zip(node, decl)]
        return torch.from_numpy(np.array(node, np.float32)).to(
            device=device, dtype=torch.float32 if f32 else decl.dtype)

    return walk(tree, build_model(cfg).decls())


def train_state_from_numpy(cfg, tcfg, state, device=None):
    """A JAX ``Trainer`` state as NumPy (``{"params", "opt": {"step", "m",
    "v"}}``; int8 moments as objects with ``q`` and ``scale``, the JAX
    ``QTensor``) -> the port's state: the parameters as
    :func:`model_params_from_numpy` gives them, ``step`` a Python int, fp32
    and bf16 moments in ``tcfg.moment_dtype``'s dtype, int8 moments as the
    port's ``QTensor`` (int8 values, float32 scales)."""
    from repro_torch.training.optim import QTensor
    device = default_device(device)
    m_dt = torch.bfloat16 if tcfg.moment_dtype == "bf16" else torch.float32

    def moments(node):
        if isinstance(node, dict):
            return {k: moments(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [moments(v) for v in node]
        if hasattr(node, "q") and hasattr(node, "scale"):
            return QTensor(
                q=torch.from_numpy(np.array(node.q, np.int8)).to(device),
                scale=torch.from_numpy(np.array(node.scale, np.float32)).to(
                    device))
        return torch.from_numpy(np.array(node, np.float32)).to(
            device=device, dtype=m_dt)

    opt = state["opt"]
    return {"params": model_params_from_numpy(cfg, state["params"], device),
            "opt": {"step": int(np.asarray(opt["step"])),
                    "m": moments(opt["m"]), "v": moments(opt["v"])}}


def train_state_to_numpy(state):
    """The inverse of :func:`train_state_from_numpy`: floating leaves as
    float32 NumPy (which holds bf16 exactly), int8 moments as ``QTensor``s
    of NumPy arrays, ``step`` an int32 scalar."""
    from repro_torch.training.optim import QTensor

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if isinstance(node, QTensor):
            return QTensor(q=node.q.detach().cpu().numpy(),
                           scale=node.scale.detach().to("cpu",
                                                        torch.float32).numpy())
        if isinstance(node, int):
            return np.asarray(node, np.int32)
        return node.detach().to("cpu", torch.float32).numpy()

    return walk(state)
