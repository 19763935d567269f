"""Entry point of the flash attention, dispatched by device.

A CUDA tensor launches the hand-written kernel (``kernel.py``) or raises;
a CPU tensor runs the chunked plain version (``ref.py``), which keeps the
JAX model's numerics.  ``launches`` counts the kernel launches made through
``flash_attention``.
"""
from __future__ import annotations

from .kernel import flash_attention_cuda
from .ref import flash_attention_chunked

launches = 0


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0):
    """q (B,Sq,H,D); k/v (B,Skv,K,D); query row i at position ``q_offset +
    i``.  Returns (B,Sq,H,D) in q's dtype."""
    global launches
    if q.is_cuda:
        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
        launches += 1
        return out
    if q.device.type != "cpu":
        raise ValueError(f"no flash attention for device {q.device}")
    return flash_attention_chunked(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
