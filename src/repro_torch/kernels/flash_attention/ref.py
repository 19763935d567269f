"""Plain PyTorch versions of the flash attention.

``flash_attention_ref`` is the port of ``repro.kernels.flash_attention.ref``
(one dense float32 softmax over the whole (Sq, Skv) score matrix, no
``q_offset``).  ``flash_attention_chunked`` is the online softmax over KV
chunks that the JAX model runs for every full-sequence attention
(``repro.models.attention.flash_attention_jnp``), chunk fallback included:
the CPU path of ``ops.flash_attention``, and the plain version the CUDA
kernel (``kernel.py``) is held to on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(q_pos, kv_pos, *, causal: bool, window: int) -> torch.Tensor:
    """(Sq, Skv) boolean validity mask from absolute positions."""
    m = torch.ones((q_pos.shape[-1], kv_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (kv_pos[None, :] <= q_pos[:, None])
    if window > 0:
        m = m & (kv_pos[None, :] > q_pos[:, None] - window)
    return m


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,Sq,H,D); k/v (B,Skv,K,D) with H % K == 0.  Float32 softmax;
    returns (B,Sq,H,D) in q's dtype."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.reshape(b, sq, kh, g, d).float() * (d ** -0.5)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    mask = _mask(torch.arange(sq, device=q.device),
                 torch.arange(skv, device=q.device), causal=causal,
                 window=window)
    s = s.masked_fill(~mask[None, None, None], NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def flash_attention_chunked(q, k, v, *, causal: bool, window: int = 0,
                            q_offset: int = 0, kv_chunk: int = 512,
                            kv_valid=None) -> torch.Tensor:
    """Online-softmax attention over KV chunks (O(S) memory).  q (B,Sq,H,D),
    k/v (B,Skv,K,D).  Operands in the model dtype, products accumulated in
    float32 (the operands widen exactly), ``p`` rounded to the operand dtype
    before the P.V product: the numerics of ``flash_attention_jnp``.  Key
    positions >= ``kv_valid`` (when given) are masked: keys padded to a
    multiple of ``kv_chunk``, as the CUDA kernel tiles them."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = d ** -0.5
    kv_chunk = min(kv_chunk, skv)
    if skv % kv_chunk:
        kv_chunk = math.gcd(skv, kv_chunk)
    n = skv // kv_chunk

    # the scale rounded to the operand dtype, as ``jnp.asarray(scale,
    # q.dtype)``: the product of two such values rounds once either way
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    qf = (q.reshape(b, sq, kh, g, d) * scale_q).float()
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m_run = torch.full((b, sq, kh, g), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, sq, kh, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kh, g, d), dtype=torch.float32, device=q.device)
    for c in range(n):
        kx = k[:, c * kv_chunk:(c + 1) * kv_chunk].float()
        vx = v[:, c * kv_chunk:(c + 1) * kv_chunk]
        kv_pos = c * kv_chunk + torch.arange(kv_chunk, device=q.device)
        s = torch.einsum("bqkgd,bckd->bqkgc", qf, kx)
        valid = _mask(q_pos, kv_pos, causal=causal, window=window)
        if kv_valid is not None:
            valid = valid & (kv_pos < kv_valid)[None, :]
        s = s.masked_fill(~valid[None, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(q.dtype).float(), vx.float())
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.reshape(b, sq, h, d).to(q.dtype)
