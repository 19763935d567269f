"""The FSDP x TP train step of the dense family over a ("data", "model")
mesh of ranks.

The counterpart of the reference's sharded ``Trainer.train_step`` (what
``jitted`` compiles with the state's and the batch's shardings; GSPMD
partitions it there).  Here the partitioning is written out.

* **The state.** Each rank holds the local blocks that
  ``Trainer.state_specs(rules)`` gives it (``common.shard_tree``): the
  parameters and both moments.  The batch is split over ``data``.
* **The forward** is the model's own (``DecoderLM.hidden`` and
  ``loss_sums``): the step enters it through ``transformer.LayerHooks``
  (``_Hooks``) and adds only the collectives and where the gradients land.
* **FSDP.** A leaf sharded over ``data`` (its ``p_embed`` dim) is
  all-gathered along that dim just before a layer uses it
  (``_Gather``: its backward reduce-scatters the gradient back onto the
  block).  Without remat autograd keeps the gathered weight until its
  backward; under ``cfg.remat`` the layer runs under ``checkpoint`` with
  the gather inside, so the weight is freed after the forward and
  gathered again in the backward.  With ``tcfg.hoist_gather`` every leaf
  is gathered once a step instead of once a microbatch, the gradients
  accumulate on the gathered weights, and one reduce-scatter a leaf ends
  the step.
* **TP (Megatron).** Under the ``head_tp`` policy the q/k/v and gate/up
  projections are split by column and ``wo`` and ``w_down`` by row over
  ``model``: each rank attends over its own heads with the flash kernel
  (``models.attention.attention_block``) and adds its partial output in
  one all-reduce (``_ReduceFromModel``); the inputs of the two blocks go
  through ``_CopyToModel``, whose backward adds the ranks' input
  gradients.  When ``n_kv_heads`` does not divide over ``model`` the KV
  projections are replicated (``rules_for``) and each rank selects the
  KV heads of its query heads; the ranks' partial gradients of those
  leaves are added over ``model`` at the end of the step.
* **The experts (the MoE family, under ``head_tp``).** The router is
  declared ``p_embed`` and gathered over ``data`` like any other leaf; the
  experts are stored expert-parallel (``p_experts`` over ``data``,
  ``p_mlp`` over ``model``, the reference's train rules) and never
  gathered.  A MoE layer's tokens go through ``models.moe._moe_local``,
  the counterpart of the reference's ``shard_map`` body: its token
  exchange over ``data`` is ``_Exchange`` (an equal-chunk all-to-all,
  whose backward is the same exchange of the gradient) and its deferred
  sum over ``model`` is ``_ReduceFromModel``, with ``_CopyToModel`` on its
  input.  So an expert's gradient is whole on the rank that holds it (the
  tokens of every data rank reached it), and the router, computed on every
  ``model`` rank from the same tokens, takes a partial gradient there (its
  weights multiply that rank's part of the expert output), which is added
  over ``model`` at the end of the step, as the replicated KV
  projections' are.  With a capacity per rank (``moe._capacity``) a copy
  may drop, which the one-device step's ``moe_dense`` never does; the
  step counts the copies kept (``moe_kept``).
* **The vocabulary.** The embedding table and the LM head are stored
  sharded over ``model`` (``p_vocab``) and all-gathered whole for the
  lookup and the loss; every rank then computes the same gradient of the
  whole table and keeps its block.  A vocabulary-parallel loss is left to
  port.
* **Sums.** Every cross-rank sum of the step adds the ranks' parts in
  group-rank order (``launch.mesh.reduce_scatter`` and ``all_reduce``).
  The loss of a microbatch is its NLL sum over its scored positions
  across the data ranks; its gradient is each rank's
  NLL sum over that global count, summed over ``data``.  The gradient
  norm adds each block once (the ranks holding a replica of a block at
  coordinate 0 of the axes it is replicated over).

Every collective is a counted wrapper of ``launch.mesh``;
``analysis.roofline.sharded_train_bytes`` states what one step moves.
The recurrent and encoder-decoder families, the ``seq_sp`` policy, the
shared expert and plans that mix MoE and dense FFN layers are not ported
here and raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.common.params import (dim_axes, local_block, map_tree,
                                       param_specs)
from repro_torch.launch.mesh import (Mesh, all_gather, all_reduce,
                                     all_to_all, gather_dim, reduce_scatter)
from repro_torch.models.moe import _moe_local, router_decls
from repro_torch.models.transformer import LayerHooks
from .optim import sum_squares, tree_leaves, tree_unflatten
from .train_step import _micro

_AXES = ("data", "model")


class _Gather(torch.autograd.Function):
    """Forward: ``x``'s blocks along ``dim`` over ``group`` gathered whole.
    Backward: ``"sum"``, the gradient reduce-scattered back onto the block
    (the ranks' batch shards add up); ``"slice"``, this rank's block of
    the gradient (every rank of the group holds the same whole one)."""

    @staticmethod
    def forward(ctx, x, dim, group, index, how):
        ctx.dim, ctx.group, ctx.index, ctx.how = dim, group, index, how
        ctx.size = x.shape[dim]
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.how == "sum":
            g = reduce_scatter(g, ctx.group, ctx.dim)
        else:
            g = g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size).contiguous()
        return g, None, None, None, None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward adds the model ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The model ranks' partial outputs added; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Exchange(torch.autograd.Function):
    """Equal chunks of dim 0 exchanged over ``group``
    (``launch.mesh.all_to_all``).  The exchange is a permutation of the
    chunks that is its own inverse, so its backward is the same exchange
    of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group), None


class _Hooks(LayerHooks):
    """The step's hooks into ``DecoderLM.hidden``: a layer's gathers and
    KV-head selection (``ShardedStep._layer_params``), and Megatron's
    identity / all-reduce pair around attention and the MLP over
    ``model``."""

    def __init__(self, step: "ShardedStep", gather: bool):
        self.step, self.gather = step, gather

    def layer(self, params, si, j):
        return self.step._layer_params(params, si, j, self.gather)

    def to_model(self, x):
        g = self.step.model_g
        return x if g is None else _CopyToModel.apply(x, g)

    def from_model(self, x):
        g = self.step.model_g
        return x if g is None else _ReduceFromModel.apply(x, g)

    def moe(self, cfg, params, x):
        """The expert-parallel body on this rank's tokens: the router
        gathered whole, this rank's experts, the exchange and the ``model``
        sum in their autograd forms."""
        st = self.step
        b, s, d = x.shape
        stats = {}
        y = _moe_local(cfg, self.to_model(x).reshape(b * s, d),
                       params["router"], params["w_gate"], params["w_up"],
                       params["w_down"], n_dest=st.dp, data_group=st.data,
                       model_group=st.model_g, stats=stats,
                       exchange=_Exchange.apply,
                       reduce=_ReduceFromModel.apply)
        keep = stats["keep"].detach()
        st.moe_kept = st.moe_kept + torch.stack(
            [keep.sum(), torch.tensor(keep.numel(), device=keep.device)])
        return y.reshape(b, s, d)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """How the step treats one parameter leaf: the dims gathered over
    ``data`` (reduce-scattered back) and over ``model`` (the vocabulary:
    its block kept), whether it is an expert leaf (its ``p_experts`` dim
    over ``data`` is expert parallelism: never gathered, its gradient
    whole on its rank), whether its gradient is partial over ``model``
    (the replicated KV projections, the MoE router), and the axes it is
    replicated over."""

    spec: tuple
    data_dims: Tuple[int, ...]
    vocab_dims: Tuple[int, ...]
    expert: bool
    model_partial: bool
    replicated: Tuple[str, ...]


def _leaf_plan(decl, spec, rules, tp: int, router: bool = False) -> _Leaf:
    data_dims, vocab_dims, axes, expert = [], [], set(), False
    for dim, entry in enumerate(spec):
        got = dim_axes(entry)
        if any(a not in _AXES for a in got) or len(got) > 1:
            raise NotImplementedError(
                f"spec {spec}: the sharded step takes dims over one of "
                f"{_AXES}")
        if got == ("data",) and decl.logical[dim] == "p_experts":
            expert = True
        elif got == ("data",):
            data_dims.append(dim)
        elif got == ("model",) and decl.logical[dim] == "p_vocab":
            vocab_dims.append(dim)
        axes.update(got)
    partial = tp > 1 and (router or (
        "p_kv_heads" in decl.logical
        and rules.mesh_axes("p_kv_heads") is None))
    return _Leaf(spec, tuple(data_dims), tuple(vocab_dims), expert, partial,
                 tuple(a for a in _AXES if a not in axes))


def _unported(cfg, plan) -> Optional[str]:
    """What of ``cfg``'s plan the sharded step does not cover, or None."""
    kinds = [k for _, pattern in plan for k in pattern]
    if cfg.family not in ("dense", "moe") or any(k.block != "attn"
                                                 for k in kinds):
        return (f"the {cfg.family!r} family: TP of the recurrent and "
                "encoder-decoder families is left to port")
    if cfg.family == "moe":
        if cfg.n_shared_experts:
            return ("the shared expert (n_shared_experts "
                    f"{cfg.n_shared_experts}): its TP is left to port")
        if not all(k.is_moe for k in kinds):
            return (f"a plan that mixes MoE and dense FFN layers (moe_every "
                    f"{cfg.moe_every}) is left to port")
        if cfg.attn_policy != "head_tp":
            return (f"the {cfg.attn_policy!r} attention policy of a MoE "
                    "configuration is left to port")
    elif any(k.is_moe for k in kinds):
        return "MoE layers in a dense configuration"
    return None


class ShardedStep:
    """One sharded train step of ``trainer`` on ``mesh`` under ``rules``
    (``rules_for(cfg, mesh, "train")``): call it with this rank's local
    state and batch (``common.shard_tree`` of the whole ones under
    ``trainer.state_specs(rules)`` and ``zoo.input_logical``).  Updates the
    state in place and returns it with {"loss", "grad_norm"}, the whole
    step's values (float32 0-d on the device), as ``Trainer.train_step``
    does on one device."""

    def __init__(self, trainer, mesh: Mesh, rules):
        model, cfg = trainer.model, trainer.model.cfg
        missing = _unported(cfg, model.plan)
        if missing is not None:
            raise NotImplementedError(
                f"the sharded step covers the dense family and the MoE "
                f"family's all-MoE head_tp plans, not {missing}")
        if tuple(mesh.axis_names) != _AXES:
            raise NotImplementedError(f"mesh axes {mesh.axis_names}: the "
                                      f"sharded step runs on {_AXES}")
        self.trainer, self.model, self.cfg = trainer, model, cfg
        self.tcfg = trainer.tcfg
        self.mesh, self.rules = mesh, rules
        self.dp, self.tp = mesh.shape["data"], mesh.shape["model"]
        if self.tp > 1 and rules.mesh_axes("heads") != "model":
            raise NotImplementedError(
                "the sequence-parallel attention policy (seq_sp) is not "
                "ported: the heads must split over 'model'")
        decls = model.decls()
        self.specs = param_specs(decls, rules)
        routers = router_decls(decls)
        self.plans = map_tree(
            lambda d, s: _leaf_plan(d, s, rules, self.tp,
                                    router=id(d) in routers),
            decls, self.specs)
        self.data = mesh.group("data") if self.dp > 1 else None
        self.model_g = mesh.group("model") if self.tp > 1 else None
        self.world = mesh.group(_AXES) if mesh.size > 1 else None
        self.kv_idx = self._kv_heads()
        # the MoE copies kept and sent this step (a device tensor)
        self.moe_kept = torch.zeros(2, dtype=torch.int64)

    # -- the pieces of a leaf ------------------------------------------------
    def _gather(self, t: torch.Tensor, plan: _Leaf, offset: int = 0):
        """The leaf (or its layer slice: dims shifted by ``offset``) as the
        model uses it: gathered over ``data`` and, for the vocabulary,
        over ``model`` (through ``_Gather``, so its gradient lands on the
        block)."""
        for dim in plan.data_dims:
            if self.dp > 1:
                t = _Gather.apply(t, dim - offset, self.data,
                                  self.mesh.axis_index("data"), "sum")
        for dim in plan.vocab_dims:
            if self.tp > 1:
                t = _Gather.apply(t, dim - offset, self.model_g,
                                  self.mesh.axis_index("model"), "slice")
        return t

    def _kv_heads(self) -> Optional[torch.Tensor]:
        """The KV heads this rank's query heads read, one per run of
        ``gcd(h_loc, G)`` consecutive local query heads, when the KV
        projections are replicated over ``model``; None otherwise."""
        cfg = self.cfg
        if self.tp == 1 or self.rules.mesh_axes("p_kv_heads") is not None:
            return None
        h_loc = cfg.n_heads // self.tp
        group = cfg.n_heads // cfg.n_kv_heads
        run = math.gcd(h_loc, group)
        first = self.mesh.axis_index("model") * h_loc
        return torch.tensor([(first + i) // group
                             for i in range(0, h_loc, run)])

    # -- the forward ---------------------------------------------------------
    def _layer_params(self, lp: dict, si: int, j: int, gather: bool) -> dict:
        """A layer's parameters as this rank uses them: its shards
        gathered (when ``gather``), then the KV heads of its query heads
        selected."""
        if gather:
            lp = map_tree(lambda t, p: self._gather(t, p, offset=1), lp,
                          self.plans["segs"][si][j])
        if self.kv_idx is None:
            return lp
        attn = dict(lp["attn"])
        idx = self.kv_idx.to(attn["wk"].device)
        for key, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
            if key in attn:
                attn[key] = attn[key].index_select(dim, idx)
        return dict(lp, attn=attn)

    def _loss_sums(self, params: dict, mb: dict, gather: bool):
        """(this rank's NLL sum, its scored positions) of microbatch ``mb``
        (its rows of the batch) over ``params`` (local blocks when
        ``gather``, else gathered already): ``DecoderLM.hidden`` with this
        step's hooks."""
        tree = dict(params)
        if gather:
            tree.update({k: self._gather(v, self.plans[k])
                         for k, v in params.items() if k != "segs"})
        h = self.model.hidden(tree, mb["tokens"], mb.get("embeds"),
                              hooks=_Hooks(self, gather))
        return self.model.loss_sums(h, tree.get("out_embed", tree["embed"]),
                                    mb)

    # -- the step ----------------------------------------------------------
    def _hoisted(self, flat: List[torch.Tensor], plans: List[_Leaf]):
        with torch.no_grad():
            return [self._gather(p, pl) for p, pl in zip(flat, plans)]

    def _finish(self, acc: torch.Tensor, plan: _Leaf, hoisted: bool):
        """A leaf's accumulated gradient onto its block, summed over the
        ranks that hold parts of it."""
        if hoisted:
            for dim in plan.vocab_dims:
                if self.tp > 1:
                    acc = local_block(acc, tuple(
                        "model" if d == dim else None
                        for d in range(acc.dim())), self.mesh)
            for dim in plan.data_dims:
                if self.dp > 1:
                    acc = reduce_scatter(acc, self.data, dim)
        if not plan.data_dims and not plan.expert and self.dp > 1:
            acc = all_reduce(acc, self.data)
        if plan.model_partial:
            acc = all_reduce(acc, self.model_g)
        return acc

    def _norm(self, grads: List[torch.Tensor], plans: List[_Leaf]):
        """The whole gradient's norm: each rank's owned blocks' squares,
        then their sum over every rank in rank order."""
        c = self.mesh.coords
        own = [g for g, pl in zip(grads, plans)
               if all(c[a] == 0 for a in pl.replicated)]
        sq = (sum_squares(own) if own else
              torch.zeros((), dtype=torch.float32, device=grads[0].device))
        if self.world is not None:
            sq = all_reduce(sq[None], self.world)[0]
        return torch.sqrt(sq)

    def _row_max(self, plan: _Leaf):
        """For int8 moments: the whole rows' max |x| of a leaf whose last
        dim is split over ranks (a max over the blocks, exact)."""
        if self.tcfg.moment_dtype != "int8" or not plan.spec:
            return None
        axes = dim_axes(plan.spec[-1])
        if not axes or self.mesh.axis_size(axes) == 1:
            return None
        group = self.mesh.group(axes)
        return lambda amax: all_gather(amax[None], group).amax(0)

    def __call__(self, state: Dict[str, Any], batch: Dict[str, Any]):
        tcfg = self.tcfg
        g = tcfg.microbatches
        acc_dt = (torch.bfloat16 if tcfg.accum_dtype == "bf16"
                  else torch.float32)
        params = state["params"]
        flat = tree_leaves(params)
        plans = tree_leaves(self.plans)
        hoist = tcfg.hoist_gather
        base = self._hoisted(flat, plans) if hoist else flat
        acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
               for p in base]
        dev = flat[0].device
        self.moe_kept = torch.zeros(2, dtype=torch.int64, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(g):
            mb = {k: _micro(v, g, i) for k, v in batch.items()}
            live = [p.detach().requires_grad_() for p in base]
            tree = tree_unflatten(params, iter(live))
            tot, cnt = self._loss_sums(tree, mb, gather=not hoist)
            both = torch.stack([tot.detach(), cnt])
            if self.data is not None:
                both = all_reduce(both, self.data)
            scored = torch.clamp(both[1], min=1.0)
            parts = torch.autograd.grad(tot / scored, live)
            for a, x in zip(acc, parts):
                a.add_(x.to(acc_dt))
            loss_sum = loss_sum + both[0] / scored
            del parts, live, tree, tot
        grads = [self._finish(a, pl, hoist) for a, pl in zip(acc, plans)]
        del acc, base
        for a in grads:
            a.div_(g)
        gnorm = self._norm(grads, plans)
        self.trainer.opt.update(grads, state["opt"], params, gnorm=gnorm,
                                row_max=[self._row_max(pl) for pl in plans])
        return state, {"loss": loss_sum / g, "grad_norm": gnorm}

