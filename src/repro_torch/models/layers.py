"""Shared neural-net building blocks (functions over ParamDecl trees).

The port of ``repro.models.layers`` for the dense decoder: RMSNorm (float32
inside), RoPE, the gated MLP, the embedding lookup and the LM head.  Every
declaration takes the config's dtype.  ``chunked_softmax_xent`` waits for
the training slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import ParamDecl


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * w


def norm_decl(d: int, dtype) -> ParamDecl:
    return ParamDecl((d,), init="ones", dtype=dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S) or (S,).
    Angles, sines and the rotation in float32; the result in x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs          # (..., S, half)
    sin = torch.sin(angles)[..., None, :]                  # over the heads
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_decls(d: int, ff: int, dtype) -> dict:
    return {
        "w_gate": ParamDecl((d, ff), init="scaled", dtype=dtype),
        "w_up": ParamDecl((d, ff), init="scaled", dtype=dtype),
        "w_down": ParamDecl((ff, d), init="scaled", dtype=dtype),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_decls(padded_vocab: int, d: int, dtype) -> ParamDecl:
    return ParamDecl((padded_vocab, d), init="normal", dtype=dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def logits_for(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """h: (..., d) -> logits (..., V_padded), in the model dtype."""
    return h @ table.t()
