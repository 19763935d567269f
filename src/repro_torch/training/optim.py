"""AdamW with fp32, bf16 or int8 moments (one float32 scale per row).

The port of ``repro.training.optim``.  Trees are nested dicts and lists of
tensors, flattened as the reference flattens them (dict keys in sorted
order).  ``AdamW.update`` runs under ``torch.no_grad()``, writes the new
parameters and moments into the tensors it is given, and returns the
gradients' global norm as a tensor on their device, so a training loop
reads the host only when it wants a number.  A leaf of more than
``SLICE_ELEMS`` elements (and at least two axes) is updated in slices
along its leading axis, so its float32 temporaries stay small: every
operation of the update is elementwise and an int8 moment's scale is per
last-axis row, so the slices give the whole leaf's result bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig


@dataclasses.dataclass
class QTensor:
    """Row-quantized tensor: ``q`` int8 in the parameter's own shape, one
    float32 ``scale`` per last-dim row (shape ``param.shape[:-1]``)."""

    q: torch.Tensor
    scale: torch.Tensor


def quantize(x: torch.Tensor, row_max=None) -> QTensor:
    """``row_max`` (optional) maps the local rows' max |x| to the whole
    rows' (a row split over ranks: the max over its blocks)."""
    xf = x.float()
    if xf.ndim == 0:
        scale = torch.clamp(xf.abs() / 127.0, min=1e-12)
        scaled = xf / scale
    else:
        amax = xf.abs().amax(-1)
        if row_max is not None:
            amax = row_max(amax)
        scale = torch.clamp(amax / 127.0, min=1e-12)
        scaled = xf / scale[..., None]
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dequantize(t: QTensor) -> torch.Tensor:
    if t.q.ndim == 0:
        return t.q.float() * t.scale
    return t.q.float() * t.scale[..., None]


def tree_leaves(tree) -> List:
    """The leaves of a dict/list tree (a ``QTensor`` is a leaf), in the
    reference's order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s nesting holding the next of ``leaves`` (an
    iterator) at each leaf, in ``tree_leaves`` order: the inverse of
    ``tree_leaves``."""
    if isinstance(tree, dict):
        return {k: tree_unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_unflatten(v, leaves) for v in tree]
    return next(leaves)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _zeros_like_state(p: torch.Tensor, dtype: str):
    if dtype == "int8":
        return QTensor(q=torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                       scale=torch.zeros(p.shape[:-1] if p.ndim else (),
                                         dtype=torch.float32,
                                         device=p.device))
    return torch.zeros(p.shape, device=p.device,
                       dtype=torch.bfloat16 if dtype == "bf16"
                       else torch.float32)


def _read_state(s, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return dequantize(s)
    return s.float()


def _write_state(s, x: torch.Tensor, dtype: str, row_max=None):
    """Store the float32 moment ``x`` into the state leaf ``s``."""
    if dtype == "int8":
        t = quantize(x, row_max)
        s.q.copy_(t.q)
        s.scale.copy_(t.scale)
    else:
        s.copy_(x)          # rounds to bf16 for bf16 moments


# the largest leaf updated whole: 64 Mi elements, 256 MiB a float32
# temporary (h2o-danube-3-4b's stacked MLP leaf, 24 x 3,840 x 10,240, goes
# one layer at a time)
SLICE_ELEMS = 1 << 26


def _slices(p: torch.Tensor, limit: int):
    """Slices along p's leading axis of at most ``limit`` elements each
    (at least one row), or the whole leaf (``...``)."""
    if p.ndim < 2 or p.numel() <= limit:
        return [...]
    rows = max(1, limit // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def _part(s, sl):
    """Rows ``sl`` of a moment leaf (views: a QTensor's values and
    scales)."""
    if isinstance(s, QTensor):
        return QTensor(q=s.q[sl], scale=s.scale[sl])
    return s[sl]


def sum_squares(leaves) -> torch.Tensor:
    """The leaves' squares summed in leaf order (float32 0-d)."""
    gsq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        gsq = gsq + torch.sum(torch.square(g.float()))
    return gsq


def global_norm(leaves) -> torch.Tensor:
    """sqrt of :func:`sum_squares` (the clip's global norm)."""
    return torch.sqrt(sum_squares(leaves))


@dataclasses.dataclass(frozen=True)
class AdamW:
    cfg: TrainConfig

    def init(self, params) -> dict:
        dt = self.cfg.moment_dtype
        return {"step": 0,
                "m": tree_map(lambda p: _zeros_like_state(p, dt), params),
                "v": tree_map(lambda p: _zeros_like_state(p, dt), params)}

    @torch.no_grad()
    def update(self, grads, state: dict, params, *, gnorm=None,
               row_max=None) -> torch.Tensor:
        """One step: the parameters and ``state`` change in place; returns
        the global gradient norm (before the clip).  ``grads`` is a tree
        like ``params`` or the list of its leaves in ``tree_leaves`` order;
        leaves above ``SLICE_ELEMS`` elements go in slices.  A sharded
        step passes its local blocks with the whole gradient's norm
        (``gnorm``) and, for int8 moments, one ``quantize`` ``row_max``
        (or None) a leaf."""
        c = self.cfg
        dt = c.moment_dtype
        state["step"] += 1
        step = np.float32(state["step"])
        # bias corrections in float32, as the reference computes them
        b1c = float(np.float32(1.0) - np.float32(c.beta1) ** step)
        b2c = float(np.float32(1.0) - np.float32(c.beta2) ** step)
        flat_g = tree_leaves(grads)
        if gnorm is None:
            gnorm = global_norm(flat_g)
        clip = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
        rows = row_max or [None] * len(flat_g)
        for g_l, m_l, v_l, p_l, rm in zip(flat_g, tree_leaves(state["m"]),
                                          tree_leaves(state["v"]),
                                          tree_leaves(params), rows):
            for sl in _slices(p_l, SLICE_ELEMS):
                g = g_l[sl].float() * clip
                m_s, v_s, p = _part(m_l, sl), _part(v_l, sl), p_l[sl]
                m = c.beta1 * _read_state(m_s, dt) + (1 - c.beta1) * g
                v = c.beta2 * _read_state(v_s, dt) + (1 - c.beta2) * g * g
                mh = m / b1c
                vh = v / b2c
                delta = (mh / (torch.sqrt(vh) + c.eps)
                         + c.weight_decay * p.float())
                p.copy_(p.float() - c.learning_rate * delta)
                _write_state(m_s, m, dt, rm)
                _write_state(v_s, v, dt, rm)
                del g, m, v, mh, vh, delta
        return gnorm
