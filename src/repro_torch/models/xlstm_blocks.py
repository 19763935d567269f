"""xLSTM blocks: the mLSTM in chunked linear-attention form and the sLSTM
scan.

The port of ``repro.models.xlstm_blocks``.  The mLSTM's sigmoid forget
gate is the scalar decay per (head, step) of ``ssm.chunked_gla``; its
normalizer rides as an extra value column, so one call gives numerator and
denominator.  The sLSTM runs ``ssm.slstm_scan``.  The reference declares
``w_gates`` float32 whatever the model dtype; so does the port.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common import ParamDecl
from repro_torch.configs.base import ModelConfig
from .attention import _proj
from .layers import causal_conv1d, norm_decl, rms_norm
from .ssm import chunked_gla, gla_decode_step, slstm_scan


def _dims(cfg: ModelConfig):
    d = cfg.d_model
    d_inner = 2 * d
    h = cfg.n_heads
    dv = d_inner // h            # value dim per head
    dk = max(cfg.ssm_state, 16)  # q/k dim per head
    return d, d_inner, h, dk, dv


def mlstm_decls(cfg: ModelConfig) -> dict:
    d, d_inner, h, dk, dv = _dims(cfg)
    inner = ("p_mlp", "p_none", "p_none")
    return {
        "norm": norm_decl(d),
        "w_up": ParamDecl((d, 2 * d_inner), ("p_embed", "p_mlp"),
                          init="scaled"),
        "conv_w": ParamDecl((cfg.ssm_conv, d_inner), ("p_none", "p_mlp"),
                            init="scaled"),
        "wq": ParamDecl((d_inner, h, dk), inner, init="scaled"),
        "wk": ParamDecl((d_inner, h, dk), inner, init="scaled"),
        "wv": ParamDecl((d_inner, h, dv), inner, init="scaled"),
        "w_gates": ParamDecl((d_inner, 2, h), inner, init="scaled",
                             dtype=torch.float32),
        "head_norm": ParamDecl((h, dv), ("p_none", "p_none"), init="ones"),
        "w_down": ParamDecl((d_inner, d), ("p_mlp", "p_embed"),
                            init="scaled"),
    }


def mlstm_block(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                state: Optional[dict] = None):
    """x (B,S,d); state (decode, S = 1) ``{"s": (B,H,Dk,Dv+1) float32,
    "conv": (B,K-1,d_inner)}``.  Returns (out, new state)."""
    d, d_inner, h, dk, dv = _dims(cfg)
    b, s, _ = x.shape
    f32 = torch.float32
    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    xi, z = (xn @ params["w_up"]).chunk(2, dim=-1)

    conv_state = state["conv"] if state is not None else None
    xc, conv_tail = causal_conv1d(xi, params["conv_w"], conv_state)
    xc = F.silu(xc)

    # dk ** -0.5 is a Python float (weakly typed in JAX): q keeps its dtype
    q = _proj(xc, params["wq"]) * (dk ** -0.5)
    k = _proj(xc, params["wk"])
    v = _proj(xi, params["wv"])
    gates = (xc.to(f32) @ params["w_gates"].reshape(d_inner, 2 * h)
             ).reshape(b, s, 2, h)
    log_f = F.logsigmoid(gates[:, :, 0])                  # (B,S,H) decay
    i_gate = torch.sigmoid(gates[:, :, 1])[..., None]     # (B,S,H,1)
    k = (k.to(f32) * i_gate).to(k.dtype)
    # the normalizer column: v_aug = [v, 1]
    v_aug = torch.cat([v, torch.ones(*v.shape[:-1], 1, dtype=v.dtype,
                                     device=v.device)], dim=-1)

    if state is None:
        o, final = chunked_gla(q, k, v_aug, log_f, chunk=min(128, s))
    else:
        o, final = gla_decode_step(q[:, 0], k[:, 0], v_aug[:, 0],
                                   log_f[:, 0], state["s"])
        o = o[:, None]
    num, den = o[..., :dv], o[..., dv:]
    hseq = num / torch.clamp(den.abs(), min=1.0)
    hseq = rms_norm(hseq, params["head_norm"], cfg.norm_eps)
    hseq = hseq.reshape(b, o.shape[1], d_inner)
    out = (hseq * F.silu(z)) @ params["w_down"]
    return out, {"s": final, "conv": conv_tail}


def slstm_decls(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    return {
        "norm": norm_decl(d),
        "w_in": ParamDecl((d, 4, h, dh), ("p_embed", "p_none", "p_none",
                                          "p_none"), init="scaled"),
        "r_w": ParamDecl((4, h, dh, dh), ("p_none",) * 4, init="scaled"),
        "w_ff_up": ParamDecl((d, 4 * d), ("p_embed", "p_mlp"),
                             init="scaled"),
        "w_ff_down": ParamDecl((2 * d, d), ("p_mlp", "p_embed"),
                               init="scaled"),
        "w_out": ParamDecl((d, d), ("p_embed", "p_none"), init="scaled"),
    }


def slstm_block(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                state: Optional[dict] = None):
    """x (B,S,d); state ``{"c", "n", "h"}`` (B,H,Dh) float32 or None.
    Returns (out, the final {"c", "n", "h"})."""
    d = cfg.d_model
    b, s, _ = x.shape
    xn = rms_norm(x, params["norm"], cfg.norm_eps)
    gates = (xn @ params["w_in"].reshape(d, -1)).reshape(
        b, s, *params["w_in"].shape[1:])                 # (B,S,4,H,Dh)
    st = None if state is None else (state["c"], state["n"], state["h"])
    hs, (c, n, hf) = slstm_scan(gates, params["r_w"], st)
    hs = hs.reshape(b, s, d).to(x.dtype) @ params["w_out"]
    # the small gated FFN after the sLSTM
    a, g = (hs @ params["w_ff_up"]).chunk(2, dim=-1)
    out = (a * F.silu(g)) @ params["w_ff_down"]
    return out, {"c": c, "n": n, "h": hf}
