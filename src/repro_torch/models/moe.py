"""Mixture-of-Experts FFN.

The port of ``repro.models.moe``.  Two execution paths share one router
(``_router_topk``: float32 logits, top-k, softmax over the k values):

* ``dense`` — every expert on every token, combined with the top-k weights
  (``moe_dense``); the oracle, and the path with no active mesh.
* ``ep`` — expert parallel (``moe_ep``) over the active mesh: the experts
  are split over the ``data`` axis and each expert's FFN dim over
  ``model``, each rank holding its slice (``shard_moe_params``, the
  reference's ``shard_map`` in_specs).  Each rank's tokens go to their
  experts' ranks by one fixed-capacity ``all_to_all`` over ``data`` (a
  token copy whose slot in its expert's bucket is at or past the capacity
  is dropped) and come back by another, and the ``model`` partial sums are
  added by one ``all_reduce`` after the combine (``_moe_local``).

``moe_block(impl="auto")`` picks ``ep`` under an active mesh and ``dense``
otherwise, as the reference's does; the optional shared expert runs on
each rank's tokens with its whole weights.  The expert products are plain
matrix products in the model dtype (no TPU kernel computes them in the
reference either).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common import (ParamDecl, ShardingRules, active_mesh,
                                param_specs, shard_tree)
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh, all_reduce, all_to_all


def moe_decls(cfg: ModelConfig) -> dict:
    """Router (float32 in every model dtype, as the reference declares it),
    the stacked experts ``(E, d, ff)`` / ``(E, ff, d)`` and, with
    ``n_shared_experts``, the shared expert of width ``ff * n_shared``;
    bf16 elsewhere."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    ex = ("p_experts", "p_expert_embed", "p_mlp")
    decls = {
        "router": ParamDecl((d, e), ("p_embed", "p_none"), init="scaled",
                            dtype=torch.float32),
        "w_gate": ParamDecl((e, d, ff), ex, init="scaled"),
        "w_up": ParamDecl((e, d, ff), ex, init="scaled"),
        "w_down": ParamDecl((e, ff, d), ("p_experts", "p_mlp",
                                         "p_expert_embed"), init="scaled"),
    }
    if cfg.n_shared_experts:
        sf = ff * cfg.n_shared_experts
        decls["shared"] = {
            "w_gate": ParamDecl((d, sf), ("p_embed", "p_mlp"), init="scaled"),
            "w_up": ParamDecl((d, sf), ("p_embed", "p_mlp"), init="scaled"),
            "w_down": ParamDecl((sf, d), ("p_mlp", "p_embed"), init="scaled"),
        }
    return decls


def router_decls(decls) -> set:
    """The ids of the MoE routers' declarations in a model's declaration
    tree (``model.decls()``; each MoE layer's ``ffn`` ``router``): under TP
    every ``model`` rank computes the router from the same tokens, so the
    sharded step and its reckoning add its gradient over ``model``."""
    return {id(layer["ffn"]["router"]) for seg in decls.get("segs", ())
            for layer in seg if "router" in layer.get("ffn", {})}


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


def _capacity(cfg: ModelConfig, t_loc: int) -> int:
    """Per-expert slots of one rank's send buffer."""
    return max(4, int(-(-t_loc * cfg.top_k * cfg.capacity_factor
                        // cfg.n_experts)))


def _moe_local(cfg: ModelConfig, x_loc: torch.Tensor,
               router_w: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor, w_down: torch.Tensor, *, n_dest: int,
               data_group=None, model_group=None,
               stats: Optional[dict] = None, exchange=all_to_all,
               reduce=all_reduce) -> torch.Tensor:
    """One rank's MoE body: x_loc (T_loc, d) its tokens, router_w (d, E)
    whole, w_gate/w_up (E / n_dest, d, ff_loc) and w_down (E / n_dest,
    ff_loc, d) its experts.  Standalone with ``n_dest=1`` and no groups.
    ``stats`` (optional) receives ``keep``, the (T_loc·k,) mask of the
    (token, expert) copies that found a slot.  ``exchange(t, group)`` and
    ``reduce(t, group)`` are the token exchange over ``data`` and the sum
    over ``model``: ``launch.mesh``'s ``all_to_all`` and ``all_reduce``
    here, their autograd forms in the sharded train step
    (``training.sharded``)."""
    t_loc, d = x_loc.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // n_dest
    cap = _capacity(cfg, t_loc)
    dev = x_loc.device

    weights, idx, _ = _router_topk(x_loc, router_w, k)          # (T, k)
    flat_e = idx.reshape(-1)                                    # (T·k,)
    # each copy's slot in its expert's bucket: its rank among the copies
    # sent to that expert, in (token, choice) order
    onehot = F.one_hot(flat_e, e)
    slot = ((onehot.cumsum(0) - 1) * onehot).sum(-1)
    keep = slot < cap                                           # drop mask
    if stats is not None:
        stats["keep"] = keep
    src_token = torch.arange(t_loc, device=dev).repeat_interleave(k)
    # a dropped copy goes to the spare slot ``cap``, which is cut off
    send = torch.zeros((e, cap + 1, d), dtype=x_loc.dtype, device=dev)
    send[flat_e, torch.where(keep, slot, cap)] = x_loc[src_token]
    send = send[:, :cap].contiguous()

    if data_group is not None and n_dest > 1:
        # (E, cap, d) = n_dest chunks of E_loc experts: chunk i to rank i;
        # what comes back is one chunk from each source rank
        recv = exchange(send, data_group)
    else:
        recv = send
    # group by local expert: (E_loc, n_src·cap, d)
    grouped = recv.reshape(n_dest, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, n_dest * cap, d)
    y = (F.silu(torch.bmm(grouped, w_gate)) * torch.bmm(grouped, w_up)
         ) @ w_down                                 # (E_loc, n_src·cap, d)
    # the ff_loc partials are summed over 'model' after the combine: the
    # sum commutes with the return route and the weighted combine, and the
    # combined (T, d) buffer is top_k times smaller than the expert buffer
    y = y.reshape(e_loc, n_dest, cap, d).transpose(0, 1).contiguous()
    if data_group is not None and n_dest > 1:
        y = exchange(y, data_group)
    y = y.reshape(e, cap, d)

    gathered = y[flat_e, slot.clamp(max=cap - 1)]               # (T·k, d)
    gathered = torch.where(keep[:, None], gathered.float(), 0.0)
    gathered = (gathered * weights.reshape(-1, 1)).reshape(t_loc, k, d)
    # each token's k copies added in (token, choice) order from zero, as
    # the reference's scatter-add does
    out = torch.zeros((t_loc, d), dtype=torch.float32, device=dev)
    for j in range(k):
        out = out + gathered[:, j]
    out = out.to(x_loc.dtype)
    if model_group is not None:
        out = reduce(out, model_group)              # deferred TP reduction
    return out


def _groups(mesh: Optional[Mesh]):
    """(n_dest, the data group or None, the model group or None)."""
    if mesh is None:
        return 1, None, None
    n_dest = mesh.shape.get("data", 1)
    data = mesh.group("data") if n_dest > 1 else None
    model = (mesh.group("model") if mesh.shape.get("model", 1) > 1
             else None)
    return n_dest, data, model


# the reference's shard_map in_specs of the expert leaves: experts over
# ``data``, each expert's FFN dim over ``model``
_EP_RULES = ShardingRules({"p_experts": "data", "p_mlp": "model"})
_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def shard_moe_params(cfg: ModelConfig, params: dict, mesh: Mesh) -> dict:
    """This rank's slice of one layer's MoE parameters under ``mesh``: the
    expert leaves' blocks under their declarations' specs in ``_EP_RULES``
    (``shard_tree``); the router and the shared expert whole."""
    specs = param_specs(moe_decls(cfg), _EP_RULES)
    out = dict(params)
    out.update(shard_tree({k: params[k] for k in _EXPERT_KEYS},
                          {k: specs[k] for k in _EXPERT_KEYS}, mesh))
    return out


def moe_ep(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
           stats: Optional[dict] = None) -> torch.Tensor:
    """Expert-parallel MoE over the active mesh: x (b, s, d) this rank's
    tokens, ``params`` this rank's slice (``shard_moe_params``).  With no
    mesh, or no ``data`` axis, the tokens stay on their rank
    (``_moe_local(n_dest=1)``), as the reference's fallback does."""
    b, s, d = x.shape
    n_dest, data, model = _groups(active_mesh())
    y = _moe_local(cfg, x.reshape(b * s, d), params["router"],
                   params["w_gate"], params["w_up"], params["w_down"],
                   n_dest=n_dest, data_group=data, model_group=model,
                   stats=stats)
    return y.reshape(b, s, d)


def moe_block(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
              impl: str = "auto") -> torch.Tensor:
    """Routed experts plus the optional shared expert (added in x's
    dtype)."""
    if impl == "auto":
        impl = "ep" if active_mesh() is not None else "dense"
    y = moe_ep(cfg, params, x) if impl == "ep" else moe_dense(cfg, params, x)
    if cfg.n_shared_experts:
        sp = params["shared"]
        h = F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])
        y = y + h @ sp["w_down"]
    return y
