"""Declarative parameter trees for the port's predictor and models.

A model declares its parameters as a nested dict/list of :class:`ParamDecl`
leaves; :func:`init_params` turns it into the same nesting of tensors.  The
init draws from an explicit ``torch.Generator`` on the generator's own
device and then moves to the target device: the predictor draws on a CPU
generator, so one seed gives it the same weights on every device; a model
draws on a generator of its target device, so billions of normals never pass
through host memory.  It does not reproduce ``jax.random``: weights that
must match the JAX package are carried across with
:mod:`repro_torch.convert`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch


def default_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one."""
    return torch.device("cuda" if device is None else device)


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    """Declaration of a single parameter tensor."""

    shape: Tuple[int, ...]
    init: str = "normal"                  # normal | zeros | ones | scaled
    scale: float = 0.02
    dtype: torch.dtype = torch.float32


def _init_leaf(decl: ParamDecl, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if decl.init == "zeros":
        return torch.zeros(decl.shape, dtype=decl.dtype, device=device)
    if decl.init == "ones":
        return torch.ones(decl.shape, dtype=decl.dtype, device=device)
    # float32 draw on the generator's device, scaled in place
    draw = torch.randn(decl.shape, generator=gen, dtype=torch.float32,
                       device=gen.device)
    if decl.init == "scaled":
        # variance-scaled (fan-in) init, the JAX package's rule verbatim
        fan_in = decl.shape[-2] if len(decl.shape) >= 2 else decl.shape[-1]
        draw.div_(np.sqrt(max(fan_in, 1)))
    else:
        draw.mul_(decl.scale)
    return draw.to(device=device, dtype=decl.dtype)


def init_params(decls, gen: torch.Generator, device=None):
    """Initialize a nested dict/list of ParamDecl (dict keys in sorted
    order, as JAX flattens them) into tensors on ``device``."""
    device = default_device(device)

    def walk(node):
        if isinstance(node, ParamDecl):
            return _init_leaf(node, gen, device)
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return [walk(v) for v in node]

    return walk(decls)
