"""Serving scheduler helper of the control loop: the stateless routing
path.

The port of ``repro.core.scheduler.route_via_batch``.  The event-driven
simulator (``run_serving``) waits for ROADMAP Queue A 7, and the online
fold-back of completions (``fold_completions``) waits with
``MultiLLMServer(fold_online=True)``.
"""
from __future__ import annotations

import numpy as np

from .baselines import Policy


def route_via_batch(policy: Policy, ds_like, loads, counts, rng=None
                    ) -> np.ndarray:
    """The one stateless admission/routing path: produce a RouteBatch from
    the admitted queries + fleet state and hand it to the policy.
    Ground-truth arrays are materialized only for policies that declare
    they need them (Oracle) — a live engine has no truth, and building it
    would inflate the measured routing overhead."""
    batch = ds_like.route_batch(np.asarray(loads, float), counts,
                                with_truth=getattr(policy, "needs_truth",
                                                   False))
    return np.asarray(policy.route(batch, rng=rng)).astype(int)
