"""SolveCert: an independent NumPy feasibility certifier for dual solves.

The paper's headline guarantee is constraint satisfaction — the router's
output respects per-endpoint capacity and the budget/α threshold.  The
solver reports ``SolveInfo.feasible``, but that is the solver grading its
own homework.  :func:`certify_window` re-derives everything from the raw
assignment and the input matrices, in NumPy, with none of the solver's
code in the loop, and returns a :class:`Certificate`:

* every chosen index is a real endpoint (``0 <= x < M``);
* per-endpoint assignment counts respect ``loads`` whenever the instance
  has enough total capacity for the valid rows (when it does not, a
  violation is impossible to avoid and is recorded, not raised);
* the solver-reported masked window cost/quality sums match an independent
  valid-prefix recompute (this is also the "pad rows contribute zero"
  proof: any pad leakage breaks the equality);
* when the solver claims feasibility, the realized cost is within the
  effective budget threshold (budget mode) / the realized mean quality
  meets the α threshold (quality mode);
* the complementary-slackness residual ``|λ| · max(slack, 0)`` (normalized
  by the threshold scale) is recorded and, for claimed-feasible solves,
  bounded — a large λ against large slack means the dual solve did not
  actually converge to the reported operating point.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional

import numpy as np

#: ring buffer of the most recent certificates (tests inspect it)
last_certificates: collections.deque = collections.deque(maxlen=256)

#: default bound on the normalized complementary-slackness residual for
#: claimed-feasible solves.  Deliberately lenient: warm-started streaming
#: windows run few iterations and carry slack by design; the bound exists
#: to catch order-of-magnitude non-convergence, not to grade tightness.
CS_BOUND = 5.0


class SolveCertError(AssertionError):
    """A route_window result failed independent feasibility certification."""


@dataclasses.dataclass
class Certificate:
    mode: str
    n_valid: int
    counts: np.ndarray        # per-endpoint assignment counts (valid rows)
    csum: float               # independent recompute of the window cost
    qsum: float               # independent recompute of the window quality
    t_eff: float              # effective threshold the solver targeted
    lam: float
    feasible: bool            # the solver's own claim
    cs_residual: float
    violations: List[str]

    @property
    def ok(self) -> bool:
        return not self.violations


def certify_window(x, cost, quality, t_eff, loads, mode, *,
                   n_valid: Optional[int] = None, lam=None, feasible=None,
                   csum=None, qsum=None, atol: float = 1e-5,
                   rtol: float = 1e-4, cs_bound: Optional[float] = None,
                   strict: bool = True) -> Certificate:
    """Certify one window assignment; raise :class:`SolveCertError` on any
    hard violation (``strict=False`` records instead)."""
    x = np.asarray(x)
    cost = np.asarray(cost, np.float64)
    quality = np.asarray(quality, np.float64)
    loads = np.asarray(loads, np.float64)
    n, m = cost.shape
    nv = n if n_valid is None else int(n_valid)
    lam_f = float(np.asarray(lam)) if lam is not None else 0.0
    feas = bool(np.asarray(feasible)) if feasible is not None else True
    t_eff = float(np.asarray(t_eff))
    if cs_bound is None:
        cs_bound = CS_BOUND
    tol = atol + rtol * max(1.0, abs(t_eff))

    violations: List[str] = []
    xv = x[:nv]
    if nv and (xv.min() < 0 or xv.max() >= m):
        violations.append(f"assignment out of range [0, {m}): "
                          f"min {xv.min()}, max {xv.max()}")
        xv = np.clip(xv, 0, m - 1)
    counts = np.bincount(xv, minlength=m).astype(np.float64)

    if loads.sum() >= nv and (counts > loads + 0.5).any():
        over = np.nonzero(counts > loads + 0.5)[0]
        violations.append(
            f"capacity violated at endpoint(s) {over.tolist()}: counts "
            f"{counts[over].tolist()} > loads {loads[over].tolist()}")

    rows = np.arange(nv)
    csum_np = float(cost[rows, xv].sum()) if nv else 0.0
    qsum_np = float(quality[rows, xv].sum()) if nv else 0.0
    if csum is not None and abs(float(csum) - csum_np) > tol:
        violations.append(
            f"solver window cost {float(csum)} != valid-prefix recompute "
            f"{csum_np} (pad rows leaked into the masked sum?)")
    if qsum is not None and abs(float(qsum) - qsum_np) > tol:
        violations.append(
            f"solver window quality {float(qsum)} != valid-prefix "
            f"recompute {qsum_np} (pad rows leaked into the masked sum?)")

    slack = 0.0
    if mode == "budget":
        slack = t_eff - csum_np
        if feas and csum_np > t_eff + tol:
            violations.append(
                f"claimed feasible but realized cost {csum_np} exceeds the "
                f"effective budget {t_eff}")
    elif mode == "quality" and nv:
        qmean = qsum_np / nv
        slack = qmean - t_eff
        if feas and qmean < t_eff - tol:
            violations.append(
                f"claimed feasible but realized mean quality {qmean} is "
                f"below the α threshold {t_eff}")

    cs_residual = abs(lam_f) * max(slack, 0.0) / max(1.0, abs(t_eff))
    if feas and np.isfinite(cs_residual) and cs_residual > cs_bound:
        violations.append(
            f"complementary-slackness residual {cs_residual:.3g} exceeds "
            f"{cs_bound} (λ={lam_f:.3g} against slack {slack:.3g}: the dual "
            f"did not converge to the reported operating point)")

    cert = Certificate(mode=mode, n_valid=nv, counts=counts, csum=csum_np,
                       qsum=qsum_np, t_eff=t_eff, lam=lam_f, feasible=feas,
                       cs_residual=cs_residual, violations=violations)
    if strict and violations:
        raise SolveCertError("SolveCert: " + "; ".join(violations))
    return cert
