"""Trainer: the microbatched language-model train step, on one device and
sharded over a mesh of ranks.

The port of ``repro.training.train_step.Trainer`` for every model of the
zoo.  The batch is split into
``tcfg.microbatches`` along its leading axis; each microbatch's loss is
differentiated over the parameter leaves (``torch.autograd.grad`` on
detached views that require a gradient, so the state's tensors never do),
its gradients are added into an accumulator of ``accum_dtype`` as the
reference adds them (``a + x.astype(acc_dt)``), the sum is divided by the
microbatch count, and ``AdamW.update`` writes the new parameters and
moments in place.  The metrics stay on the device.

``abstract_state`` is the state as meta tensors, ``state_specs`` the mesh
axes of every leaf under a rule table (int8 moments: ``q`` as its
parameter, ``scale`` its leading axes), and ``sharded_step`` the
counterpart of the reference's ``jitted``: the same step over a ("data",
"model") mesh of ranks, each holding its blocks of the state
(``training.sharded``: FSDP x TP for the dense family, with the
``hoist_gather`` branch).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.common.params import map_tree, param_specs, param_structs
from repro_torch.configs.base import TrainConfig
from .optim import AdamW, QTensor, tree_leaves, tree_map


@dataclasses.dataclass
class Trainer:
    model: Any
    tcfg: TrainConfig

    def __post_init__(self):
        self.opt = AdamW(self.tcfg)

    # -- state ----------------------------------------------------------------
    def init_state(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Random parameters (``model.init(seed, device)``) and zeroed
        moments."""
        params = self.model.init(seed, device)
        return {"params": params, "opt": self.opt.init(params)}

    def abstract_state(self) -> Dict[str, Any]:
        """The state's shapes and dtypes as ``meta`` tensors (nothing is
        allocated)."""
        params = param_structs(self.model.decls())
        return {"params": params, "opt": self.opt.init(params)}

    def state_specs(self, rules) -> Dict[str, Any]:
        """The mesh axes of every state leaf under ``rules`` (tuples, the
        reference's PartitionSpecs): the parameters' from their logical
        axes; the moments shard as their parameters, an int8 moment's
        ``scale`` over its parameter's leading axes; ``step`` replicated."""
        p_specs = param_specs(self.model.decls(), rules)
        if self.tcfg.moment_dtype == "int8":
            m_specs = map_tree(lambda s: QTensor(q=s, scale=s[:-1]),
                               p_specs)
        else:
            m_specs = p_specs
        return {"params": p_specs,
                "opt": {"step": (), "m": m_specs, "v": m_specs}}

    def sharded_step(self, mesh, rules):
        """The counterpart of the reference's ``jitted``: a callable
        ``(local state, local batch) -> (state, metrics)`` running this
        step over ``mesh`` under ``rules`` (``training.sharded.
        ShardedStep``)."""
        from .sharded import ShardedStep
        return ShardedStep(self, mesh, rules)

    # -- step -----------------------------------------------------------------
    def train_step(self, state: Dict[str, Any], batch: Dict[str, Any]
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        """One optimizer step on ``batch`` (tensors on the parameters'
        device, leading axis a multiple of ``tcfg.microbatches``).  Updates
        ``state`` in place and returns it with {"loss": the mean of the
        microbatch losses, "grad_norm": the global norm of the averaged
        gradient}, float32 0-d tensors on the device."""
        tcfg = self.tcfg
        params = state["params"]
        g = tcfg.microbatches
        acc_dt = torch.bfloat16 if tcfg.accum_dtype == "bf16" else torch.float32
        flat = tree_leaves(params)
        grads = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                 for p in flat]
        loss_sum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        for i in range(g):
            mb = {k: _micro(v, g, i) for k, v in batch.items()}
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss = self.model.loss(live, mb)
            parts = torch.autograd.grad(loss, tree_leaves(live))
            for acc, x in zip(grads, parts):
                acc.add_(x.to(acc_dt))
            loss_sum = loss_sum + loss.detach()
            del parts, loss, live
        for acc in grads:
            acc.div_(g)
        gnorm = self.opt.update(grads, state["opt"], params)
        return state, {"loss": loss_sum / g, "grad_norm": gnorm}


def _micro(x, g: int, i: int):
    """Microbatch i of g along the leading axis (the reference's reshape to
    (g, B // g, ...) and scan over its first axis)."""
    if x is None:
        return None
    if x.shape[0] % g:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                         f"{g} microbatches")
    m = x.shape[0] // g
    return x[i * m:(i + 1) * m]
