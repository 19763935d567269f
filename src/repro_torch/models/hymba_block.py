"""Hymba layer: parallel attention heads and SSD (Mamba-2 style) heads on
the same input (arXiv:2411.13676).  The branch outputs are normalized and
averaged with learnable per-branch scales.

The port of ``repro.models.hymba_block``.  The attention branch goes
through the port's hand-written kernels (``attention.attention_block``:
flash on the full sequence, paged or dense decode on one token); the SSD
branch is ``ssm.chunked_gla`` over the sequence and ``ssm.gla_decode_step``
on one token.  The reference declares ``w_dt``, ``dt_bias``, ``a_log``,
``d_skip`` and ``beta`` float32 whatever the model dtype; so does the port.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common import ParamDecl
from repro_torch.configs.base import ModelConfig
from .attention import _proj, attention_block, attn_decls
from .layers import causal_conv1d, norm_decl, rms_norm
from .ssm import chunked_gla, gla_decode_step


def ssd_decls(cfg: ModelConfig) -> dict:
    d, h, p, n = cfg.d_model, cfg.n_heads, cfg.hd, cfg.ssm_state
    f32 = torch.float32
    ex = ("p_embed", "p_none", "p_none")
    return {
        "w_x": ParamDecl((d, h, p), ex, init="scaled"),
        "w_z": ParamDecl((d, h, p), ex, init="scaled"),
        "w_b": ParamDecl((d, h, n), ex, init="scaled"),
        "w_c": ParamDecl((d, h, n), ex, init="scaled"),
        "w_dt": ParamDecl((d, h), ("p_embed", "p_none"), init="scaled",
                          dtype=f32),
        "dt_bias": ParamDecl((h,), ("p_none",), init="zeros", dtype=f32),
        "a_log": ParamDecl((h,), ("p_none",), init="zeros", dtype=f32),
        "d_skip": ParamDecl((h,), ("p_none",), init="ones", dtype=f32),
        "conv_w": ParamDecl((cfg.ssm_conv, h * p), ("p_none", "p_none"),
                            init="scaled"),
    }


def ssd_branch(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
               state: Optional[dict] = None):
    """The SSD selective-state branch.  x (B,S,d), normed; state (decode,
    S = 1) ``{"s": (B,H,N,P) float32, "conv": (B,K-1,H·P)}``.  Returns
    (out (B,S,H·P), {"s", "conv"})."""
    b, s, _ = x.shape
    h, p = cfg.n_heads, cfg.hd
    f32 = torch.float32
    xh = _proj(x, params["w_x"])                           # (B,S,H,P)
    conv_state = state["conv"] if state is not None else None
    xf, conv_tail = causal_conv1d(xh.reshape(b, s, h * p), params["conv_w"],
                                  conv_state)
    xh = F.silu(xf).reshape(b, s, h, p)

    bmat = _proj(x, params["w_b"])
    cmat = _proj(x, params["w_c"])
    dt = F.softplus(x.to(f32) @ params["w_dt"] + params["dt_bias"])
    log_a = -dt * torch.exp(params["a_log"])               # (B,S,H) float32
    v = (xh.to(f32) * dt[..., None]).to(x.dtype)

    if state is None:
        y, final = chunked_gla(cmat, bmat, v, log_a, chunk=min(128, s))
    else:
        y, final = gla_decode_step(cmat[:, 0], bmat[:, 0], v[:, 0],
                                   log_a[:, 0], state["s"])
        y = y[:, None]
    y = y + xh * params["d_skip"].to(x.dtype).reshape(1, 1, h, 1)
    z = _proj(x, params["w_z"])
    y = (y * F.silu(z)).reshape(b, y.shape[1], h * p)
    return y, {"s": final, "conv": conv_tail}


def hymba_decls(cfg: ModelConfig) -> dict:
    d_inner = cfg.n_heads * cfg.hd
    return {
        "norm": norm_decl(cfg.d_model),
        "attn": attn_decls(cfg),
        "ssd": ssd_decls(cfg),
        "attn_norm": norm_decl(d_inner),
        "ssd_norm": norm_decl(d_inner),
        "beta": ParamDecl((2,), ("p_none",), init="ones",
                          dtype=torch.float32),
    }


def hymba_layer(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                window: int = 0, q_offset: int = 0,
                cache: Optional[dict] = None, prewritten: bool = False):
    """Attention ∥ SSD.  ``cache`` (decode): the attention cache of
    ``attention_block`` (``k``/``v`` or the page pools, ``pos``) plus the
    SSD state ``s`` and ``conv``.  Returns (out, (new_kv, new_ssm_state)):
    new_kv is the prefill's (k, v) on the full sequence, None on decode."""
    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    attn_cache, ssm_state = None, None
    if cache is not None:
        attn_cache = {k: cache[k] for k in
                      ("k", "v", "k_pages", "v_pages", "block_table", "pos")
                      if k in cache}
        ssm_state = {"s": cache["s"], "conv": cache["conv"]}
    attn_out, new_kv = attention_block(
        cfg, params["attn"], xn, causal=True, window=window,
        q_offset=q_offset, cache=attn_cache, prewritten=prewritten)
    ssd_out, new_ssm = ssd_branch(cfg, params["ssd"], xn, state=ssm_state)
    # the SSD heads fold back through the attention's output projection
    ssd_out = ssd_out @ params["attn"]["wo"].reshape(cfg.n_heads * cfg.hd,
                                                     -1)
    beta = params["beta"]
    a = rms_norm(attn_out, params["attn_norm"], cfg.norm_eps)
    m = rms_norm(ssd_out, params["ssd_norm"], cfg.norm_eps)
    # JAX promotes a bf16 array times a float32 0-d array to float32, so
    # the scaled sum is float32, rounded once to x's dtype; 0.5 is exact
    out = (beta[0] * a.to(torch.float32)
           + beta[1] * m.to(torch.float32)).to(x.dtype) * 0.5
    return out, (new_kv, new_ssm)
