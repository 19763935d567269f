"""Attention for the dense decoder: the online-softmax full-sequence
(prefill) path in plain PyTorch, and the paged decode path through the
hand-written kernel.

The port of ``repro.models.attention`` for the branches the paged serving
plane runs: the full-sequence branch (``flash_attention``, the counterpart
of ``flash_attention_jnp``, which the JAX package computes outside any
Pallas kernel), the prewritten paged decode branch
(``kernels.decode_attention.ops.paged_decode_attention``) and its
multi-position twin, the speculative verify
(``kernels.decode_attention.ops.paged_verify_attention``): the CUDA kernels
on a CUDA tensor, their plain versions on a CPU tensor.  Cross-attention
and the dense-cache decode raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common import ParamDecl
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as decode_ops
from .layers import rope

NEG_INF = -1e30


def attn_decls(cfg: ModelConfig) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.dtype
    decls = {
        "wq": ParamDecl((d, h, hd), init="scaled", dtype=dt),
        "wk": ParamDecl((d, k, hd), init="scaled", dtype=dt),
        "wv": ParamDecl((d, k, hd), init="scaled", dtype=dt),
        "wo": ParamDecl((h, hd, d), init="scaled", dtype=dt),
    }
    if cfg.qkv_bias:
        decls["bq"] = ParamDecl((h, hd), init="zeros", dtype=dt)
        decls["bk"] = ParamDecl((k, hd), init="zeros", dtype=dt)
        decls["bv"] = ParamDecl((k, hd), init="zeros", dtype=dt)
    return decls


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _pos2d(pos, s: int) -> torch.Tensor:
    """Decode positions (B, S) from per-sequence lengths (B,)."""
    base = torch.arange(s, dtype=torch.int32, device=pos.device)
    return pos[:, None] + base[None, :]


def _mask(q_pos, kv_pos, *, causal: bool, window: int) -> torch.Tensor:
    """(Sq, Skv) boolean validity mask from absolute positions."""
    m = torch.ones((q_pos.shape[-1], kv_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (kv_pos[None, :] <= q_pos[:, None])
    if window > 0:
        m = m & (kv_pos[None, :] > q_pos[:, None] - window)
    return m


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0, kv_chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention over KV chunks (O(S) memory).  q (B,Sq,H,D),
    k/v (B,Skv,K,D).  Operands in the model dtype, products accumulated in
    float32 (the operands widen exactly), ``p`` rounded to the operand dtype
    before the P.V product: the numerics of ``flash_attention_jnp``."""
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


def project_kv_token(cfg: ModelConfig, params: dict, x: torch.Tensor, pos,
                     use_rope: bool = True):
    """K/V projection (+RoPE at pos) for one decode token. x: (B,1,d);
    pos the per-sequence (B,) int positions."""
    k_new = _proj(x, params["wk"])
    v_new = _proj(x, params["wv"])
    if "bk" in params:
        k_new, v_new = k_new + params["bk"], v_new + params["bv"]
    if use_rope:
        k_new = rope(k_new, _pos2d(pos, x.shape[1]), cfg.rope_theta)
    return k_new, v_new


def attention_block(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_x=None, cache=None, use_rope: bool = True,
                    cross_cached: bool = False, prewritten: bool = False):
    """Projections + RoPE + core + output projection.  Returns (out, new_kv):
    new_kv is this call's (k, v) on the full-sequence branch (the prefill
    cache) and None on the paged branches, whose caller has already written
    the K/V of every query position into the page pools.  On the paged
    branch x may carry S > 1 positions per sequence (the speculative
    verify): position s sits at ``pos[b] + s`` and attends to positions <=
    ``pos[b] + s``."""
    if kv_x is not None or cross_cached:
        raise NotImplementedError("cross-attention is not ported yet")
    q = _proj(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    if cache is not None:
        if not prewritten or "k_pages" not in cache:
            raise NotImplementedError(
                "only the prewritten paged decode is ported; the dense-cache "
                "decode waits")
        pos = cache["pos"]
        sq = x.shape[1]
        if use_rope:
            q = rope(q, _pos2d(pos, sq), cfg.rope_theta)
        # speculative verify: S prewritten positions per sequence, one pass
        attend = (decode_ops.paged_verify_attention if sq > 1
                  else decode_ops.paged_decode_attention)
        out = attend(q, cache["k_pages"], cache["v_pages"],
                     cache["block_table"], pos + 1, window=window)
        new_kv = None
    else:
        k = _proj(x, params["wk"])
        v = _proj(x, params["wv"])
        if "bk" in params:
            k, v = k + params["bk"], v + params["bv"]
        if use_rope:
            q_pos = q_offset + torch.arange(x.shape[1], device=x.device)
            kv_pos = torch.arange(x.shape[1], device=x.device)
            q = rope(q, q_pos[None, :], cfg.rope_theta)
            k = rope(k, kv_pos[None, :], cfg.rope_theta)
        out = flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
        new_kv = (k, v)
    b, s, h, hd = out.shape
    y = out.reshape(b, s, h * hd) @ params["wo"].reshape(h * hd, -1)
    return y, new_kv
