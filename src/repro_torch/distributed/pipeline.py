"""GPipe-style pipeline parallelism over a ``"stage"`` mesh axis.

The port of ``repro.distributed.pipeline``: each rank of the ``"stage"``
axis holds one stage's parameters; microbatches flow stage to stage by
``send``/``recv``, and the last stage's outputs are broadcast to every
stage.  Stage ``s`` works on microbatch ``t - s`` at tick ``t`` (ticks
``0 … M + S - 2``; the bubble is (S-1)/(S-1+M) of them).  The reference
shifts every stage's buffer around the ring at every tick; here a stage
sends only what the next stage will use: a microbatch it worked on, and
never from the last stage to the first, which takes fresh microbatches.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.launch.mesh import Mesh, broadcast, recv, send


def pipeline_forward(mesh: Mesh, stage_fn: Callable, n_microbatches: int):
    """Build the pipelined forward ``run(params_local, x_all)``: x_all
    (M, mb, ...) the same on every stage, ``params_local`` this stage's
    parameters; ``stage_fn(params, x_mb) -> x_mb`` keeps the microbatch's
    shape.  Every stage returns the (M, mb, ...) outputs of the last."""
    n_stages = mesh.shape["stage"]
    assert n_microbatches >= n_stages

    def run(params_local, x_all: torch.Tensor) -> torch.Tensor:
        sid = mesh.axis_index("stage")
        ranks = mesh.ranks_along("stage")
        last = n_stages - 1
        out = torch.zeros_like(x_all)
        for t in range(n_microbatches + n_stages - 1):
            mb = t - sid
            if not 0 <= mb < n_microbatches:
                continue
            x_in = x_all[mb] if sid == 0 else recv(x_all[0],
                                                   ranks[sid - 1])
            y = stage_fn(params_local, x_in)
            if sid == last:
                out[mb] = y
            else:
                send(y, ranks[sid + 1])
        return broadcast(out, ranks[last], mesh.group("stage"))

    return run
