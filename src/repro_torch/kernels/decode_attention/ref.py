"""Plain PyTorch versions of the paged decode attention.

Counterparts of ``repro.kernels.decode_attention.ref`` (``gather_pages``,
``decode_attention_ref``, ``paged_decode_attention_ref``, and for the
speculative verify ``verify_attention_ref``, ``paged_verify_attention_ref``
and the NumPy oracle ``paged_verify_attention_np``, copied as it is), and
``decode_attention_partials_ref``, the plain version of the dense decode's
unmerged split partials (the reference kernel's own output, which its
``ops.merge_partials`` merges).  The softmax
and both products run in float32 on operands widened from their storage
type, and the result is rounded once to q's type: the numerics of the TPU
kernel, which the CUDA kernel (``kernel.py``) shares.  These versions gather
the block-table pages into a dense copy; the kernel does not.

A sequence with no valid position (lens 0, or a window past every written
position) gets the mean of every gathered V here, as in the JAX reference
(``exp(NEG_INF - NEG_INF) = 1``); the CUDA kernel gives 0 there, as the
NumPy oracle does.  The serving path attends over ``lens + 1 >= 1``
positions, so it never produces such a row.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernel import SPLIT_POS

NEG_INF = -1e30


def gather_pages(k_pages: torch.Tensor, block_table: torch.Tensor
                 ) -> torch.Tensor:
    """(n_pages, PS, K, D) + (B, P) -> dense (B, P·PS, K, D) copy."""
    b, p = block_table.shape
    ps, kh, d = k_pages.shape[1:]
    return k_pages[block_table.long()].reshape(b, p * ps, kh, d)


def decode_attention_ref(q, k_cache, v_cache, lens, *, window: int = 0):
    """q (B,1,H,D); caches (B,T,K,D); lens (B,) int valid lengths.  Float32
    softmax; returns (B,1,H,D) in q's dtype."""
    b, _, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qf = q.reshape(b, kh, g, d).float() * (d ** -0.5)
    s = torch.einsum("bkgd,btkd->bkgt", qf, k_cache.float())
    kv = torch.arange(t, device=q.device)
    pcol = lens.to(torch.int32).reshape(-1, 1)
    valid = kv[None, :] < pcol
    if window > 0:
        valid = valid & (kv[None, :] > pcol - 1 - window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_partials_ref(q, k_cache, v_cache, lens):
    """The split partials of :func:`decode_attention_ref` over splits of
    ``SPLIT_POS`` positions (the CUDA kernel's): q (B,1,H,D); caches
    (B,T,K,D); lens (B,) valid lengths, clamped to [0, T].  Returns float32
    o (B,K,S,G,D) the unnormalised P.V numerators, m and l (B,K,S,G) the
    score max and the exp sum; a split with no valid position gives (0,
    NEG_INF, 0)."""
    b, _, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g, ns = h // kh, -(-t // SPLIT_POS)
    pad = ns * SPLIT_POS - t
    kc = torch.nn.functional.pad(k_cache.float(), (0, 0, 0, 0, 0, pad))
    vc = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, 0, 0, pad))
    kc = kc.reshape(b, ns, SPLIT_POS, kh, d)
    vc = vc.reshape(b, ns, SPLIT_POS, kh, d)
    qf = q.reshape(b, kh, g, d).float() * (d ** -0.5)
    s = torch.einsum("bkgd,bnpkd->bkngp", qf, kc)
    n = torch.clamp(lens.to(torch.int32), 0, t).reshape(b, 1, 1)
    pos = torch.arange(ns * SPLIT_POS, device=q.device).reshape(
        1, ns, SPLIT_POS)
    valid = (pos < n)[:, None, :, None, :]                 # (B,1,S,1,P)
    m = torch.where(valid, s, float("-inf")).amax(-1)
    m = torch.where(torch.isinf(m), torch.full_like(m, NEG_INF), m)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bkngp,bnpkd->bkngd", p, vc)
    return o, m, p.sum(-1)


def paged_decode_attention_ref(q, k_pages, v_pages, block_table, lens, *,
                               window: int = 0):
    """Gather the block-table pages into a dense per-sequence view, then the
    lens-masked split-free softmax of :func:`decode_attention_ref`."""
    return decode_attention_ref(q, gather_pages(k_pages, block_table),
                                gather_pages(v_pages, block_table),
                                lens, window=window)


def verify_attention_ref(q, k_cache, v_cache, lens, *, window: int = 0):
    """Speculative-verify version: q (B,S,H,D) — query s of sequence b sits
    at position ``lens[b] - 1 + s`` and attends to positions < ``lens[b] +
    s``.  Float32 softmax; returns (B,S,H,D) in q's dtype."""
    b, s_q, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qf = q.reshape(b, s_q, kh, g, d).float() * (d ** -0.5)
    s = torch.einsum("bskgd,btkd->bskgt", qf, k_cache.float())
    kv = torch.arange(t, device=q.device)
    # per-position valid lengths: (B, S, 1)
    pcol = (lens.to(torch.int32).reshape(-1, 1)
            + torch.arange(s_q, device=q.device)[None, :])[:, :, None]
    valid = kv[None, None, :] < pcol
    if window > 0:
        valid = valid & (kv[None, None, :] > pcol - 1 - window)
    s = s.masked_fill(~valid[:, :, None, None, :], NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    o = torch.einsum("bskgt,btkd->bskgd", p, v_cache.float())
    return o.reshape(b, s_q, h, d).to(q.dtype)


def paged_verify_attention_ref(q, k_pages, v_pages, block_table, lens, *,
                               window: int = 0):
    """Gather the block-table pages into a dense view, then the
    per-position causal mask of :func:`verify_attention_ref`."""
    return verify_attention_ref(q, gather_pages(k_pages, block_table),
                                gather_pages(v_pages, block_table),
                                lens, window=window)


def paged_verify_attention_np(q, k_pages, v_pages, block_table, lens, *,
                              window: int = 0):
    """NumPy oracle for the paged verify step: a per-(sequence, position)
    python loop — query s of sequence b sees positions [lo, lens[b] + s)."""
    in_dtype = np.asarray(q).dtype
    q = np.asarray(q, np.float32)
    k_pages = np.asarray(k_pages, np.float32)
    v_pages = np.asarray(v_pages, np.float32)
    block_table = np.asarray(block_table)
    lens = np.asarray(lens)
    b, s_q, h, d = q.shape
    ps, kh = k_pages.shape[1], k_pages.shape[2]
    g = h // kh
    out = np.zeros((b, s_q, h, d), np.float32)
    for i in range(b):
        pages = block_table[i]
        kd = k_pages[pages].reshape(-1, kh, d)
        vd = v_pages[pages].reshape(-1, kh, d)
        for j in range(s_q):
            n = int(lens[i]) + j
            lo = max(0, n - window) if window > 0 else 0
            if n - lo <= 0:
                continue
            k = kd[lo:n]
            v = vd[lo:n]
            qi = q[i, j].reshape(kh, g, d) * (d ** -0.5)
            s = np.einsum("kgd,tkd->kgt", qi, k)
            s = s - s.max(-1, keepdims=True)
            p = np.exp(s)
            p = p / p.sum(-1, keepdims=True)
            out[i, j] = np.einsum("kgt,tkd->kgd", p, v).reshape(h, d)
    return out.astype(in_dtype)
