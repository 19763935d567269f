"""Per-endpoint health state for failure-aware routing.

A NumPy copy of ``repro.core.health`` (``tests/test_torch_boundary.py``
holds the two equal on one event trace).

``HealthTracker`` carries the circuit-breaker state machine plus failure-
and latency-EWMAs as (M,) arrays.  The tracker is the *single* owner of
that state: executors report outcomes via
:meth:`record`, the control loop advances wall-clock transitions via
:meth:`advance`, and the routing side reads three pure views —
:meth:`effective_loads` (open breakers -> capacity 0, half-open -> probe
slots), :meth:`price_multiplier` (latency EWMA folded into the cost
column, always >= 1 so the budget ledger only ever *over*-estimates), and
:meth:`admissible` (dispatch-time gate).

Breaker state machine::

    CLOSED --(fail EWMA > open_threshold, >= min_events)--> OPEN
    OPEN   --(cooldown elapsed)-------------------------> HALF_OPEN
    HALF_OPEN --(probe_successes wins & EWMA <= close_threshold)--> CLOSED
    HALF_OPEN --(any probe failure)--------------------------> OPEN

``close_threshold < open_threshold`` gives the hysteresis band: a breaker
that just closed needs sustained failures to re-open, and one that just
opened needs sustained successes to close.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CLOSED, OPEN, HALF_OPEN = 0, 1, 2

_STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half_open"}


@dataclass(frozen=True)
class HealthConfig:
    """Breaker thresholds and EWMA gains."""
    ewma_alpha: float = 0.35        # EWMA step for both failure and latency
    open_threshold: float = 0.5     # fail EWMA above this trips the breaker
    close_threshold: float = 0.25   # ... and must fall below this to close
    min_events: int = 3             # never trip on fewer observations
    cooldown: float = 8.0           # OPEN dwell (sim seconds / engine steps)
    probe_slots: int = 1            # concurrent probes allowed half-open
    probe_successes: int = 2        # wins needed to close
    latency_gain: float = 1.0       # cost-repricing sensitivity
    latency_cap: float = 4.0        # max price multiplier from latency


class HealthTracker:
    """Mutable per-endpoint health state.  All mutation lives here."""

    def __init__(self, m: int, cfg: HealthConfig = None):
        self.cfg = cfg or HealthConfig()
        self.m = int(m)
        self.breaker_state = np.zeros(self.m, dtype=np.int32)   # CLOSED
        self.fail_ewma = np.zeros(self.m, dtype=np.float64)
        self.lat_ewma = np.full(self.m, np.nan, dtype=np.float64)
        self.open_until = np.zeros(self.m, dtype=np.float64)
        self.probe_inflight = np.zeros(self.m, dtype=np.int32)
        self.probe_wins = np.zeros(self.m, dtype=np.int32)
        self.events_seen = np.zeros(self.m, dtype=np.int64)
        self.trips = 0

    # -- event ingestion ------------------------------------------------

    def record(self, j: int, ok: bool, latency: float = None,
               now: float = 0.0) -> None:
        """Fold one request outcome on endpoint ``j`` into the EWMAs and
        drive the breaker state machine."""
        c = self.cfg
        j = int(j)
        self.events_seen[j] += 1
        self.fail_ewma[j] += c.ewma_alpha * (
            (0.0 if ok else 1.0) - self.fail_ewma[j])
        if ok and latency is not None:
            prev = self.lat_ewma[j]
            lat = float(latency)
            self.lat_ewma[j] = lat if np.isnan(prev) else (
                prev + c.ewma_alpha * (lat - prev))
        st = int(self.breaker_state[j])
        if st == HALF_OPEN:
            if self.probe_inflight[j] > 0:
                self.probe_inflight[j] -= 1
            if ok:
                self.probe_wins[j] += 1
                if (self.probe_wins[j] >= c.probe_successes
                        and self.fail_ewma[j] <= c.close_threshold):
                    self.breaker_state[j] = CLOSED
                    self.probe_wins[j] = 0
                    self.probe_inflight[j] = 0
            else:                       # a failed probe reopens immediately
                self._trip(j, now)
        elif st == CLOSED:
            if (not ok and self.events_seen[j] >= c.min_events
                    and self.fail_ewma[j] > c.open_threshold):
                self._trip(j, now)

    def note_admit(self, j: int) -> None:
        """An executor admitted a request on ``j`` — count half-open probes."""
        j = int(j)
        if self.breaker_state[j] == HALF_OPEN:
            self.probe_inflight[j] += 1

    def _trip(self, j: int, now: float) -> None:
        self.breaker_state[j] = OPEN
        self.open_until[j] = float(now) + self.cfg.cooldown
        self.probe_wins[j] = 0
        self.probe_inflight[j] = 0
        self.trips += 1

    # -- time -----------------------------------------------------------

    def advance(self, now: float) -> None:
        """OPEN breakers whose cooldown elapsed move to HALF_OPEN."""
        due = (self.breaker_state == OPEN) & (self.open_until <= now + 1e-9)
        if due.any():
            self.breaker_state[due] = HALF_OPEN
            self.probe_wins[due] = 0
            self.probe_inflight[due] = 0

    def next_wake(self, now: float):
        """Earliest strictly-future breaker cooldown expiry, else None —
        a wake source so an all-open pool doesn't dead-end the loop."""
        mask = self.breaker_state == OPEN
        if not mask.any():
            return None
        t = float(self.open_until[mask].min())
        return t if t > now + 1e-9 else None

    # -- pure views for the routing side ---------------------------------

    def effective_loads(self, loads) -> np.ndarray:
        """Capacity vector with breakers folded in: OPEN -> 0, HALF_OPEN ->
        at most ``probe_slots``.  Idempotent."""
        out = np.asarray(loads, dtype=np.float64).copy()
        out[self.breaker_state == OPEN] = 0.0
        half = self.breaker_state == HALF_OPEN
        out[half] = np.minimum(out[half], float(self.cfg.probe_slots))
        return out

    def price_multiplier(self) -> np.ndarray:
        """(M,) cost multiplier from the latency EWMAs, relative to the
        pool median.  Clipped to [1, latency_cap]: repricing may only
        *raise* predicted cost, so the budget ledger stays conservative."""
        out = np.ones(self.m, dtype=np.float64)
        seen = ~np.isnan(self.lat_ewma)
        if seen.sum() < 2:
            return out
        med = float(np.median(self.lat_ewma[seen]))
        if med <= 0.0:
            return out
        rel = self.lat_ewma[seen] / med
        out[seen] = np.clip(1.0 + self.cfg.latency_gain * (rel - 1.0),
                            1.0, self.cfg.latency_cap)
        return out

    def admissible(self, j: int) -> bool:
        """Dispatch-time gate: never admit on OPEN; HALF_OPEN admits only
        while a probe slot is free."""
        j = int(j)
        st = int(self.breaker_state[j])
        if st == OPEN:
            return False
        if st == HALF_OPEN:
            return int(self.probe_inflight[j]) < self.cfg.probe_slots
        return True

    # -- introspection ----------------------------------------------------

    def state_name(self, j: int) -> str:
        return _STATE_NAMES[int(self.breaker_state[int(j)])]

    def __repr__(self):  # pragma: no cover - debugging aid
        states = ",".join(self.state_name(j) for j in range(self.m))
        return f"HealthTracker(m={self.m}, states=[{states}], trips={self.trips})"
