"""LedgerSan: per-window invariants on the streaming dual ledger.

The ``DualState`` ledger is the contract that lets a budget hold across an
entire stream: ``budget_spent`` must be the exact running sum of realized
window costs (conservation), must never decrease (monotone), and in budget
mode must never exceed the global budget the controller was given.  Pad
rows added by the pow2 bucketing must provably contribute zero — the
solver's masked ``csum`` is re-derived from the chosen valid-prefix entries
by :mod:`.solvecert` and conservation is checked against it here.

:func:`check_window_transition` is the stateless inductive check the solver
hook runs per window; :class:`LedgerSan` additionally accumulates its own
independent spend total across windows, so wholesale ledger replacement
(e.g. a ``_replace(budget_spent=...)`` that staticcheck SC07 would flag
statically) is caught at runtime too.
"""
from __future__ import annotations

import numpy as np


class LedgerSanError(AssertionError):
    """A DualState ledger invariant was violated."""


def _f(v) -> float:
    return float(np.asarray(v))


def _tol(ref: float, atol: float = 1e-5, rtol: float = 1e-4) -> float:
    return atol + rtol * abs(ref)


def check_state_monotone(state_in, state_out, where: str = ""):
    """The cheap host-level check (StreamController / OmniRouter): spend and
    step counters never move backwards, spend stays finite and nonnegative.
    Works on the fused predict→solve path too — it only reads the concrete
    output state, never intermediate device values."""
    from . import counters
    counters["checks"] += 1
    tag = f" [{where}]" if where else ""
    spent0, spent1 = _f(state_in.budget_spent), _f(state_out.budget_spent)
    steps0, steps1 = _f(state_in.steps), _f(state_out.steps)
    if not np.isfinite(spent1):
        raise LedgerSanError(f"LedgerSan{tag}: budget_spent became "
                             f"non-finite ({spent1})")
    if spent1 < spent0 - _tol(spent0):
        raise LedgerSanError(
            f"LedgerSan{tag}: budget_spent decreased {spent0} -> {spent1} "
            f"(the ledger only ever accumulates)")
    if spent1 < -_tol(0.0):
        raise LedgerSanError(f"LedgerSan{tag}: negative budget_spent {spent1}")
    if steps1 < steps0:
        raise LedgerSanError(
            f"LedgerSan{tag}: steps decreased {steps0} -> {steps1}")


def check_window_transition(*, mode, threshold, state_in, state_out,
                            csum, qsum, n_valid, iters_run,
                            atol: float = 1e-5, rtol: float = 1e-4):
    """Inductive conservation check for one ``route_window`` transition.

    ``threshold`` here is the *global* constraint route_window was given
    (budget mode: the stream's total budget B; quality mode: α), which is
    what makes "never exceeds budget" checkable per window.
    """
    csum, qsum, threshold = _f(csum), _f(qsum), _f(threshold)
    spent0, spent1 = _f(state_in.budget_spent), _f(state_out.budget_spent)
    steps0, steps1 = _f(state_in.steps), _f(state_out.steps)
    def1 = _f(state_out.sr_deficit)
    def0 = _f(state_in.sr_deficit)
    nv = int(n_valid) if n_valid is not None else None
    iters = _f(iters_run)

    if csum < -_tol(0.0, atol, rtol):
        raise LedgerSanError(f"LedgerSan: negative window cost {csum}")
    if abs(spent1 - (spent0 + csum)) > _tol(spent0 + csum, atol, rtol):
        raise LedgerSanError(
            f"LedgerSan: budget conservation broken: "
            f"{spent0} + {csum} != {spent1} (ledger overwritten?)")
    if abs(steps1 - (steps0 + iters)) > 0.5:
        raise LedgerSanError(
            f"LedgerSan: steps {steps0} + iters_run {iters} != {steps1}")
    if mode == "budget":
        if spent1 > threshold + _tol(threshold, atol, rtol):
            raise LedgerSanError(
                f"LedgerSan: cumulative spend {spent1} exceeds the global "
                f"budget {threshold}")
        if abs(def1 - def0) > _tol(def0, atol, rtol):
            raise LedgerSanError(
                f"LedgerSan: sr_deficit moved in budget mode "
                f"({def0} -> {def1})")
    elif mode == "quality" and nv is not None:
        want = def0 + threshold * nv - qsum
        if abs(def1 - want) > _tol(want, atol, rtol):
            raise LedgerSanError(
                f"LedgerSan: sr_deficit {def1} != {def0} + {threshold}*{nv} "
                f"- {qsum} = {want}")


class LedgerSan:
    """Stateful cross-window auditor: keeps its own independent running
    totals and re-checks every observed transition against them."""

    def __init__(self, mode: str, threshold: float):
        self.mode = mode
        self.threshold = float(threshold)
        self.spent = 0.0
        self.windows = 0

    def observe(self, state_in, state_out, *, csum, qsum=0.0,
                n_valid=None, iters_run=0):
        from . import counters
        counters["checks"] += 1
        check_state_monotone(state_in, state_out, where="LedgerSan.observe")
        check_window_transition(
            mode=self.mode, threshold=self.threshold, state_in=state_in,
            state_out=state_out, csum=csum, qsum=qsum, n_valid=n_valid,
            iters_run=iters_run)
        self.spent += _f(csum)
        self.windows += 1
        spent1 = _f(state_out.budget_spent)
        if abs(spent1 - self.spent) > _tol(self.spent):
            raise LedgerSanError(
                f"LedgerSan: ledger says {spent1} spent but the independent "
                f"sum of {self.windows} window costs is {self.spent} "
                f"(ledger overwritten between windows?)")
