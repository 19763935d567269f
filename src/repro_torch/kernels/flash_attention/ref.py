"""Plain PyTorch versions of the flash attention.

``flash_attention_ref`` is the port of ``repro.kernels.flash_attention.ref``
(one dense float32 softmax over the whole (Sq, Skv) score matrix, no
``q_offset``).  ``flash_attention_chunked`` is the online softmax over KV
chunks that the JAX model runs for every full-sequence attention
(``repro.models.attention.flash_attention_jnp``), chunk fallback included:
the CPU path of ``ops.flash_attention``, and the plain version the CUDA
kernel (``kernel.py``) is held to on the card; asked for, it also gives
each row's log-sum-exp.  ``flash_attention_bwd_ref`` is the plain version
of the backward kernel: the FlashAttention-2 gradient from that
log-sum-exp, with the kernel's roundings.
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


def _acc_dtype(dtype):
    """float32 sums, float64 for float64 inputs (the gradient checks)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def flash_attention_chunked(q, k, v, *, causal: bool, window: int = 0,
                            q_offset: int = 0, kv_chunk: int = 512,
                            kv_valid=None, with_lse: bool = False):
    """Online-softmax attention over KV chunks (O(S) memory).  q (B,Sq,H,D),
    k/v (B,Skv,K,D).  Operands in the model dtype, products accumulated in
    float32 (the operands widen exactly), ``p`` rounded to the operand dtype
    before the P.V product: the numerics of ``flash_attention_jnp``.  Key
    positions >= ``kv_valid`` (when given) are masked: keys padded to a
    multiple of ``kv_chunk``, as the CUDA kernel tiles them.  Returns
    (B,Sq,H,D) in q's dtype; with ``with_lse``, (out, lse) with lse
    (B,H,Sq) each row's m + log(l) in the accumulation dtype."""
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
    acc_dt = _acc_dtype(q.dtype)
    qf = (q.reshape(b, sq, kh, g, d) * scale_q).to(acc_dt)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m_run = torch.full((b, sq, kh, g), NEG_INF, dtype=acc_dt,
                       device=q.device)
    l_run = torch.zeros((b, sq, kh, g), dtype=acc_dt, device=q.device)
    acc = torch.zeros((b, sq, kh, g, d), dtype=acc_dt, device=q.device)
    for c in range(n):
        kx = k[:, c * kv_chunk:(c + 1) * kv_chunk].to(acc_dt)
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
            "bqkgc,bckd->bqkgd", p.to(q.dtype).to(acc_dt), vx.to(acc_dt))
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    out = out.reshape(b, sq, h, d).to(q.dtype)
    if not with_lse:
        return out
    lse = (m_run + torch.log(l_run)).reshape(b, sq, h).permute(0, 2, 1)
    return out, lse.contiguous()


def flash_attention_bwd_ref(q, k, v, out, dout, lse, *, causal: bool,
                            window: int = 0, q_offset: int = 0,
                            kv_chunk: int = 1024):
    """The gradient (dq, dk, dv) of the flash attention at (q, k, v), given
    its output ``out``, the output's cotangent ``dout`` (both (B,Sq,H,D))
    and each row's log-sum-exp ``lse`` (B,H,Sq): the FlashAttention-2 form
    of the backward kernel, over KV chunks of ``kv_chunk`` positions (the
    chunking changes no sum of the result).  S = (q * scale rounded to q's
    dtype) . K^T, P = exp(S - lse) (0 where masked), Delta = rowsum(dout o
    out), dV = P^T . dout, dS = P o (dout . V^T - Delta), dK = dS^T . (q *
    scale), dQ = scale * (dS . K), P and dS rounded to q's dtype before
    their products, dQ rounded to it before the scale and after.  Sums in
    float32 (float64 for float64 inputs).  A row with no visible position
    gets and gives zero gradients.  Returns the three in the inputs'
    dtype."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    dt = q.dtype
    acc_dt = _acc_dtype(dt)
    scale_q = float(torch.tensor(d ** -0.5, dtype=dt))
    qs = (q.reshape(b, sq, kh, g, d) * scale_q).to(acc_dt)
    dof = dout.reshape(b, sq, kh, g, d).to(acc_dt)
    delta = (dof * out.reshape(b, sq, kh, g, d).to(acc_dt)).sum(-1)
    lse_r = lse.to(acc_dt).permute(0, 2, 1).reshape(b, sq, kh, g)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    dq = torch.zeros((b, sq, kh, g, d), dtype=acc_dt, device=q.device)
    dk = torch.zeros((b, skv, kh, d), dtype=acc_dt, device=q.device)
    dv = torch.zeros((b, skv, kh, d), dtype=acc_dt, device=q.device)
    for c0 in range(0, skv, kv_chunk):
        c1 = min(c0 + kv_chunk, skv)
        kx = k[:, c0:c1].to(acc_dt)
        vx = v[:, c0:c1].to(acc_dt)
        kv_pos = torch.arange(c0, c1, device=q.device)
        valid = _mask(q_pos, kv_pos, causal=causal, window=window)
        s = torch.einsum("bqkgd,bckd->bqkgc", qs, kx)
        p = torch.where(valid[None, :, None, None, :],
                        torch.exp(s - lse_r[..., None]), 0.0)
        dp = torch.einsum("bqkgd,bckd->bqkgc", dof, vx)
        ds = (p * (dp - delta[..., None])).to(dt).to(acc_dt)
        p = p.to(dt).to(acc_dt)
        dv[:, c0:c1] = torch.einsum("bqkgc,bqkgd->bckd", p, dof)
        dk[:, c0:c1] = torch.einsum("bqkgc,bqkgd->bckd", ds, qs)
        dq += torch.einsum("bqkgc,bckd->bqkgd", ds, kx)
    dq = (dq.to(dt) * scale_q).to(dt)
    return dq.reshape(b, sq, h, d), dk.to(dt), dv.to(dt)
