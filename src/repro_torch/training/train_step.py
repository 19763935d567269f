"""Trainer: the microbatched language-model train step on one device.

The port of ``repro.training.train_step.Trainer``'s ``init_state`` and
``train_step`` for every model of the zoo.  The batch is split into
``tcfg.microbatches`` along its leading axis; each microbatch's loss is
differentiated over the parameter leaves (``torch.autograd.grad`` on
detached views that require a gradient, so the state's tensors never do),
its gradients are added into an accumulator of ``accum_dtype`` as the
reference adds them (``a + x.astype(acc_dt)``), the sum is divided by the
microbatch count, and ``AdamW.update`` writes the new parameters and
moments in place.  The metrics stay on the device.

The sharded half of the reference's ``Trainer`` (``state_specs``,
``abstract_state``, ``jitted`` and ``hoist_gather``: sharding rules, mesh
placement and AOT lowering) is part 2 of distribution (ROADMAP Queue A
item 3); part 1 gave the port its meshes (``launch.mesh``) and rule tables
(``common.sharding``, ``distributed.sharding``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from .optim import AdamW, tree_leaves, tree_map


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
