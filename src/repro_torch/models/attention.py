"""Attention for the decoder and the encoder-decoder: the full-sequence
(prefill) path, the paged decode and verify paths, the dense-cache decode
path and cross-attention, each through a hand-written kernel.

The port of ``repro.models.attention`` for the branches the serving planes
run: the full-sequence branch (``kernels.flash_attention.ops.
flash_attention``, the function ``flash_attention_jnp`` computes), the
prewritten paged decode branch (``kernels.decode_attention.ops.
paged_decode_attention``) and its multi-position twin, the speculative
verify (``kernels.decode_attention.ops.paged_verify_attention``), and the
prewritten dense-cache decode of one position (``kernels.decode_attention.
ops.decode_attention``) and of several (``ops.verify_attention``, the
same dense-cache kernel at S positions: the verify of an int8 pool's
dense view): the CUDA kernels on a CUDA tensor, their plain
versions on a CPU tensor.  Cross-attention (the encoder-decoder's) has
both of the reference's branches: over the full sequence, K/V projected
from ``kv_x`` without RoPE and attended non-causally through the flash
kernel (query and key lengths differ), and in decode, the unroped query
over a layer's cached encoder K/V through the dense-cache decode kernel at
the cache's whole length (``cross_cached``).  The decode that writes its
own K/V column (no caller in the reference reaches it) raises
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.common import ParamDecl
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from .layers import matmul, rope


def attn_decls(cfg: ModelConfig) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    decls = {
        "wq": ParamDecl((d, h, hd), ("p_embed", "p_heads", "p_none"),
                        init="scaled"),
        "wk": ParamDecl((d, k, hd), ("p_embed", "p_kv_heads", "p_none"),
                        init="scaled"),
        "wv": ParamDecl((d, k, hd), ("p_embed", "p_kv_heads", "p_none"),
                        init="scaled"),
        "wo": ParamDecl((h, hd, d), ("p_heads", "p_none", "p_embed"),
                        init="scaled"),
    }
    if cfg.qkv_bias:
        decls["bq"] = ParamDecl((h, hd), ("p_heads", "p_none"), init="zeros")
        decls["bk"] = ParamDecl((k, hd), ("p_kv_heads", "p_none"),
                                init="zeros")
        decls["bv"] = ParamDecl((k, hd), ("p_kv_heads", "p_none"),
                                init="zeros")
    return decls


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product (``layers.matmul``:
    a float32 input against bf16 weights promotes, as in JAX)."""
    d, h, k = w.shape
    return matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _pos2d(pos, s: int, device=None) -> torch.Tensor:
    """Decode positions as a 2-D (batch-broadcastable, S) tensor: a scalar
    ``pos`` (an int or a 0-d tensor) gives (1, S) shared by the batch,
    per-sequence lengths (B,) give (B, S)."""
    if not isinstance(pos, torch.Tensor):
        return (pos + torch.arange(s, dtype=torch.int32, device=device))[None]
    base = torch.arange(s, dtype=torch.int32, device=pos.device)
    if pos.dim() == 0:
        return (pos + base)[None, :]
    return pos[:, None] + base[None, :]


def project_kv_token(cfg: ModelConfig, params: dict, x: torch.Tensor, pos,
                     use_rope: bool = True):
    """K/V projection (+RoPE at pos) for one decode token. x: (B,1,d);
    pos a scalar or the per-sequence (B,) int positions."""
    k_new = _proj(x, params["wk"])
    v_new = _proj(x, params["wv"])
    if "bk" in params:
        k_new, v_new = k_new + params["bk"], v_new + params["bv"]
    if use_rope:
        k_new = rope(k_new, _pos2d(pos, x.shape[1], x.device), cfg.rope_theta)
    return k_new, v_new


def attention_block(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_x=None, cache=None, use_rope: bool = True,
                    cross_cached: bool = False, prewritten: bool = False):
    """Projections + RoPE + core + output projection.  Returns (out, new_kv):
    new_kv is this call's (k, v) on the full-sequence branch (the prefill
    cache) and None on the decode branches, whose caller has already written
    the K/V of every query position into the page pools (``k_pages``) or
    the dense cache (``k``).  On both x may carry S > 1 positions per
    sequence (the speculative verify): position s sits at ``pos[b] + s``
    and attends to positions <= ``pos[b] + s``.  Cross-attention: ``kv_x``
    (B, Skv, d) the source of K/V on the full sequence, or ``cross_cached``
    with ``cache`` {"k", "v"} (B, Skv, K, D) the cached source K/V in
    decode; new_kv is the projected (k, v) of ``kv_x``, None in decode."""
    src = x if kv_x is None else kv_x
    q = _proj(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    if cache is not None and cross_cached:
        # every cached source position is visible: lens = the cache length
        out = decode_ops.decode_attention(q, cache["k"], cache["v"],
                                          cache["k"].shape[1], window=0)
        new_kv = None
    elif cache is not None:
        sq = x.shape[1]
        paged = "k_pages" in cache
        if not prewritten:
            raise NotImplementedError(
                "only the prewritten decode is ported (the caller writes "
                "the K/V of every query position first)")
        pos = cache["pos"]
        if use_rope:
            q = rope(q, _pos2d(pos, sq, x.device), cfg.rope_theta)
        if not paged:
            attend = (decode_ops.verify_attention if sq > 1
                      else decode_ops.decode_attention)
            out = attend(q, cache["k"], cache["v"], pos + 1, window=window)
        else:
            # speculative verify: S prewritten positions per sequence, one
            # pass
            attend = (decode_ops.paged_verify_attention if sq > 1
                      else decode_ops.paged_decode_attention)
            out = attend(q, cache["k_pages"], cache["v_pages"],
                         cache["block_table"], pos + 1, window=window)
        new_kv = None
    else:
        k = _proj(src, params["wk"])
        v = _proj(src, params["wv"])
        if "bk" in params:
            k, v = k + params["bk"], v + params["bv"]
        if use_rope:
            q_pos = q_offset + torch.arange(x.shape[1], device=x.device)
            kv_pos = torch.arange(src.shape[1], device=x.device)
            q = rope(q, q_pos[None, :], cfg.rope_theta)
            k = rope(k, kv_pos[None, :], cfg.rope_theta)
        out = flash_ops.flash_attention(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset)
        new_kv = (k, v)
    b, s, h, hd = out.shape
    y = matmul(out.reshape(b, s, h * hd), params["wo"].reshape(h * hd, -1))
    return y, new_kv
