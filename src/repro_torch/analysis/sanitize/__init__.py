"""Opt-in runtime sanitizer plane of the port.

The port of ``repro.analysis.sanitize``.  Three members, all off by
default; when off, the hot paths pay one ``is None`` / set-truthiness
check and nothing else:

* **PageSan** (:mod:`.pagesan`) — a shadow allocator mirroring the serving
  engine's ``PageAllocator``/``Endpoint`` host state: double-free,
  use-after-free, cross-slot page aliasing, dump-page discipline and
  leaked pages/slots at drain.
* **LedgerSan + SolveCert** (:mod:`.ledgersan`, :mod:`.solvecert`) —
  per-window invariants on the streaming ``DualState`` ledger plus an
  independent NumPy feasibility certificate for every
  ``DualSolver.route_window`` result.  The port has no tracing, so every
  window is eager and every window is certified.
* **Race checker** (:mod:`.racecheck`, imported lazily: it pulls in the
  engine and the simulator) — seeded executors permuting same-timestamp
  event orders, with end-state invariants and seed-independent outputs.

``pagesan.py``, ``ledgersan.py`` and ``solvecert.py`` are copies of the
reference's NumPy modules.  Turn members on with the same ``REPRO_SANITIZE``
variable as the reference (comma-separated member names or ``all``, read
once at import; one switch sanitizes both packages) or the :func:`enabled`
context manager.  The hooks convert device tensors to NumPy once, here
(``.detach().cpu().numpy()``): that copy is the only host read a member
adds, and only while it is on.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np

from .pagesan import PageSan, PageSanError
from .ledgersan import LedgerSan, LedgerSanError
from .ledgersan import check_state_monotone as _check_state_monotone
from .ledgersan import check_window_transition as _check_window_transition
from .solvecert import Certificate, SolveCertError, certify_window, \
    last_certificates

ALL_MEMBERS = ("pagesan", "ledgersan", "solvecert")

#: currently-active member names.  Module-global on purpose: the engine and
#: solver hot paths gate on ``if _sanitize.ENABLED`` (set truthiness).
ENABLED: set = set()

#: work counters:
#:   events — PageSan shadow-allocator hook invocations
#:   checks — ledger/monotonicity window checks
#:   certs  — feasibility certificates issued by SolveCert
counters = {"events": 0, "checks": 0, "certs": 0}


def _parse_env() -> set:
    raw = os.environ.get("REPRO_SANITIZE", "")
    names = {s.strip().lower() for s in raw.split(",") if s.strip()}
    if "all" in names or "1" in names:
        return set(ALL_MEMBERS)
    unknown = names - set(ALL_MEMBERS)
    if unknown:
        raise ValueError(f"REPRO_SANITIZE: unknown sanitizer(s) {sorted(unknown)}; "
                         f"valid: {', '.join(ALL_MEMBERS)} (or 'all')")
    return names


ENABLED |= _parse_env()


def active(name: str) -> bool:
    """Whether one sanitizer member is currently on."""
    return name in ENABLED


def any_active() -> bool:
    return bool(ENABLED)


@contextlib.contextmanager
def enabled(*names: str):
    """Turn members on for a ``with`` block (no names = all of them).
    Nested uses compose: each exit restores the previous set."""
    want = set(names) if names else set(ALL_MEMBERS)
    unknown = want - set(ALL_MEMBERS)
    if unknown:
        raise ValueError(f"unknown sanitizer(s) {sorted(unknown)}; "
                         f"valid: {', '.join(ALL_MEMBERS)}")
    prev = set(ENABLED)
    ENABLED.clear()
    ENABLED.update(prev | want)
    try:
        yield
    finally:
        ENABLED.clear()
        ENABLED.update(prev)


@contextlib.contextmanager
def disabled():
    """Force every member off for a ``with`` block (the off-state contract
    must hold even when ``REPRO_SANITIZE`` is set)."""
    prev = set(ENABLED)
    ENABLED.clear()
    try:
        yield
    finally:
        ENABLED.clear()
        ENABLED.update(prev)


def reset_counters():
    for k in counters:
        counters[k] = 0


def _host(v):
    """A tensor as a NumPy array on the host (one copy from the device);
    anything else as NumPy sees it."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _host_state(state):
    """A ``DualState`` (a NamedTuple of tensors) with NumPy fields."""
    return type(state)(*(_host(v) for v in state))


def check_state_monotone(state_in, state_out, where: str = ""):
    """LedgerSan's host-level monotonicity check on two ``DualState``s,
    read from the device once (``ledgersan.check_state_monotone``)."""
    _check_state_monotone(_host_state(state_in), _host_state(state_out),
                          where=where)


def check_window_transition(*, state_in, state_out, **kw):
    """LedgerSan's per-window conservation check on two ``DualState``s,
    read from the device once (``ledgersan.check_window_transition``)."""
    _check_window_transition(state_in=_host_state(state_in),
                             state_out=_host_state(state_out), **kw)


def check_route_window(*, mode, x, cost, quality, threshold, t_eff, loads,
                       state_in, state_out, csum, qsum, n_valid, info):
    """The solver-side hook: called by ``DualSolver.route_window`` on every
    window while ledgersan or solvecert is on.  Converts to NumPy once
    here, so the solver itself adds no host read."""
    x = _host(x)
    cost = _host(cost)
    quality = _host(quality)
    loads = _host(loads)
    csum = float(_host(csum))
    qsum = float(_host(qsum))
    t_eff = float(_host(t_eff))
    n_valid = None if n_valid is None else int(_host(n_valid))
    if active("ledgersan"):
        counters["checks"] += 1
        check_window_transition(
            mode=mode, threshold=float(_host(threshold)), state_in=state_in,
            state_out=state_out, csum=csum, qsum=qsum, n_valid=n_valid,
            iters_run=_host(info.iters_run))
    if active("solvecert"):
        cert = certify_window(
            x, cost, quality, t_eff, loads, mode, n_valid=n_valid,
            lam=_host(info.lam), feasible=_host(info.feasible), csum=csum,
            qsum=qsum)
        counters["certs"] += 1
        last_certificates.append(cert)
