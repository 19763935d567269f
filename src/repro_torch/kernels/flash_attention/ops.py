"""Entry point of the flash attention, dispatched by device.

A CUDA tensor launches the hand-written kernel (``kernel.py``) or raises;
a CPU tensor runs the chunked plain version (``ref.py``), which keeps the
JAX model's numerics.  When any input requires a gradient (the training
path), the call is a ``torch.autograd.Function``: on a CUDA tensor its
forward launches the forward kernel with the log-sum-exp output and its
backward launches the backward kernel (``csrc/flash_attention_bwd.cu``) or
raises; on a CPU tensor both directions run their plain versions.  With
no input requiring a gradient the call is the plain forward launch.
``launches`` counts the forward kernel's launches made through
``flash_attention``, ``bwd_launches`` the backward kernel's.  Operands of
two dtypes (bf16 queries against a float32 encoder's keys) are promoted
as JAX promotes them before they reach the kernel, whose operands share
one dtype (``kernels.promoted``); the result takes q's dtype, as the
reference's does.
"""
from __future__ import annotations

import torch

from .. import promoted
from .kernel import flash_attention_bwd_cuda, flash_attention_cuda
from .ref import flash_attention_bwd_ref, flash_attention_chunked

launches = 0
bwd_launches = 0


class _FlashAttention(torch.autograd.Function):
    """The flash attention with its gradient (the training path)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        global launches
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        if q.is_cuda:
            out, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
            launches += 1
        else:
            out, lse = flash_attention_chunked(q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        global bwd_launches
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if q.is_cuda:
            grads = flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                             **ctx.kw)
            bwd_launches += 1
        else:
            grads = flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                            **ctx.kw)
        return (*grads, None, None, None)


@promoted
def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0):
    """q (B,Sq,H,D); k/v (B,Skv,K,D); query row i at position ``q_offset +
    i``.  Returns (B,Sq,H,D) in q's dtype, differentiable in q, k and v
    when any of them requires a gradient."""
    global launches
    if not q.is_cuda and q.device.type != "cpu":
        raise ValueError(f"no flash attention for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    if q.is_cuda:
        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
        launches += 1
        return out
    return flash_attention_chunked(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
