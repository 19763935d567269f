"""Compressed all-reduce with error feedback.

The port of ``repro.distributed.compression``.  ``compressed_psum``
quantizes to int8 with a float32 scale per block of 256 (round half to
even, clipped to ±127) before the mean all-reduce of the dequantised
values, or rounds to bf16; either way the residual the rounding dropped is
returned and added back into the next step's input (error feedback), so
the error does not accumulate.  Over gloo the reduction itself runs in
float32 (the dequantised values) or bf16, as the reference's does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.launch.mesh import all_reduce

_BLOCK = 256


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def _dequant(q, scale, shape) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compressed_psum(x: torch.Tensor, group,
                    error: Optional[torch.Tensor] = None, *,
                    method: str = "int8"):
    """Mean all-reduce over ``group`` with compression and error feedback.

    Returns (the group's mean, float32; the new residual).  ``error`` is
    the residual of the previous step (same shape as x; None -> zeros)."""
    if method not in ("int8", "bf16"):
        raise ValueError(f"unknown compression {method!r}")
    if error is None:
        error = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    n = torch.distributed.get_world_size(group)
    target = x.float() + error
    if method == "bf16":
        sent = target.to(torch.bfloat16)
        reduced = (all_reduce(sent, group) / n).float()
        return reduced, target - sent.float()
    q, scale = _quant(target)
    local = _dequant(q, scale, x.shape)
    return all_reduce(local, group) / n, target - local
