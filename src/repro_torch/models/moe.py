"""Mixture-of-Experts FFN on one device.

The port of ``repro.models.moe`` on its single-device path: the router
(``_router_topk``: float32 logits, top-k, softmax over the k values) and the
``dense`` execution, every expert on every token, combined with the top-k
weights (``moe_dense``), plus the optional shared expert (``moe_block``).
In the reference ``moe_block(impl="auto")`` picks ``dense`` when no mesh is
active, which is the port's only setting.  The expert products are plain
matrix products in the model dtype (no TPU kernel computes them in the
reference either).  The expert-parallel capacity dispatch over a mesh
(``_moe_local``, ``moe_ep``) is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import ParamDecl
from repro_torch.configs.base import ModelConfig


def moe_decls(cfg: ModelConfig) -> dict:
    """Router (float32 in every model dtype, as the reference declares it),
    the stacked experts ``(E, d, ff)`` / ``(E, ff, d)`` and, with
    ``n_shared_experts``, the shared expert of width ``ff * n_shared``."""
    d, ff, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.dtype
    decls = {
        "router": ParamDecl((d, e), init="scaled", dtype=torch.float32),
        "w_gate": ParamDecl((e, d, ff), init="scaled", dtype=dt),
        "w_up": ParamDecl((e, d, ff), init="scaled", dtype=dt),
        "w_down": ParamDecl((e, ff, d), init="scaled", dtype=dt),
    }
    if cfg.n_shared_experts:
        sf = ff * cfg.n_shared_experts
        decls["shared"] = {
            "w_gate": ParamDecl((d, sf), init="scaled", dtype=dt),
            "w_up": ParamDecl((d, sf), init="scaled", dtype=dt),
            "w_down": ParamDecl((sf, d), init="scaled", dtype=dt),
        }
    return decls


def _router_topk(x: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """x (T, d) -> (weights (T, k) float32, expert ids (T, k), the float32
    logits (T, E))."""
    logits = x.float() @ w_router
    top_vals, top_idx = torch.topk(logits, top_k, dim=-1)
    return torch.softmax(top_vals, dim=-1), top_idx, logits


def moe_dense(cfg: ModelConfig, params: dict, x: torch.Tensor
              ) -> torch.Tensor:
    """Every expert on every token, ``(E, T, ff)`` in the model dtype,
    combined in float32 with the ``(T, E)`` matrix that holds each token's
    top-k weights (0 elsewhere); the result in x's dtype."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    weights, idx, _ = _router_topk(xt, params["router"], cfg.top_k)
    full = torch.zeros((t, cfg.n_experts), dtype=torch.float32,
                       device=x.device).scatter_(1, idx, weights)
    h = xt @ params["w_gate"]                          # (E, T, ff)
    u = xt @ params["w_up"]
    y = (F.silu(h) * u) @ params["w_down"]             # (E, T, d)
    del h, u
    out = torch.einsum("etd,te->td", y.float(), full)
    return out.reshape(b, s, d).to(x.dtype)


def moe_block(cfg: ModelConfig, params: dict, x: torch.Tensor
              ) -> torch.Tensor:
    """Routed experts plus the optional shared expert (added in x's
    dtype)."""
    y = moe_dense(cfg, params, x)
    if cfg.n_shared_experts:
        sp = params["shared"]
        h = F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])
        y = y + h @ sp["w_down"]
    return y
