"""Seeded fault injection for the serving plane.

A standard-library copy of ``repro.serving.faults``, with its own
:data:`counters` (``tests/test_torch_boundary.py`` holds the two equal).

A :class:`FaultPlan` maps endpoint index -> fault specs and answers the
executors' questions deterministically: *is endpoint j hard-down at time
t?*, *what latency factor applies?*, *is it rate-limited, and to what
capacity?*, *does this particular request flake?*.  Error-rate coins are
drawn from a stateless splitmix64-style hash of ``(seed, endpoint, key,
salt)`` — never from a stateful RNG — so outcomes are identical under any
event ordering and across retries (each attempt salts the hash
differently).

Zero-overhead off: the executors gate every consult on ``plan is not
None``; when no plan is attached, nothing in this module runs.  The
module-level :data:`counters` make that structurally checkable: a
fault-free run must leave them at 0.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Sequence

#: work counters for the structural zero-overhead assert:
#:   checks   — FaultPlan consultations by an executor
#:   injected — faults actually injected (downs, flakes, limits, spikes)
counters = {"checks": 0, "injected": 0}


def reset_counters():
    for k in counters:
        counters[k] = 0


def _u01(*keys) -> float:
    """Stateless hash of integer keys -> uniform [0, 1).  splitmix64-ish:
    order of *events* never matters, only the keys themselves."""
    h = 0x9E3779B97F4A7C15
    for k in keys:
        h = (h + (int(k) & 0xFFFFFFFFFFFFFFFF)) & 0xFFFFFFFFFFFFFFFF
        h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return (h >> 11) / float(1 << 53)


@dataclass(frozen=True)
class FaultSpec:
    """One fault on one endpoint over a time window ``[start, end)``.

    kind:
      * ``hard_down``     — endpoint serves nothing while active
      * ``error_rate``    — each request fails with prob ``rate``
      * ``latency_spike`` — service time multiplied by ``factor``
      * ``rate_limit``    — concurrent capacity clamped to ``capacity``
    """
    kind: str
    start: float = 0.0
    end: float = math.inf
    rate: float = 0.0
    factor: float = 2.0
    capacity: int = 1

    def __post_init__(self):
        if self.kind not in ("hard_down", "error_rate", "latency_spike",
                             "rate_limit"):
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def active(self, t: float) -> bool:
        return self.start <= t < self.end


class FaultPlan:
    """Per-endpoint fault schedule, deterministic under ``seed``."""

    def __init__(self, specs: Mapping[int, Sequence[FaultSpec]], seed: int = 0):
        self.specs = {int(j): tuple(v) for j, v in specs.items()}
        self.seed = int(seed)

    def _on(self, j: int) -> Sequence[FaultSpec]:
        return self.specs.get(int(j), ())

    def down(self, j: int, t: float) -> bool:
        """Hard-down right now?"""
        counters["checks"] += 1
        hit = any(s.kind == "hard_down" and s.active(t) for s in self._on(j))
        if hit:
            counters["injected"] += 1
        return hit

    def down_during(self, j: int, t0: float, t1: float) -> bool:
        """Any hard-down window overlapping ``[t0, t1)``?  Used by the sim
        to kill requests that were in flight when the endpoint died."""
        counters["checks"] += 1
        hit = any(s.kind == "hard_down" and s.start < t1 and t0 < s.end
                  for s in self._on(j))
        if hit:
            counters["injected"] += 1
        return hit

    def latency_factor(self, j: int, t: float) -> float:
        """Product of active latency-spike factors (1.0 when none)."""
        counters["checks"] += 1
        f = 1.0
        for s in self._on(j):
            if s.kind == "latency_spike" and s.active(t):
                f *= float(s.factor)
        if f != 1.0:
            counters["injected"] += 1
        return f

    def rate_limit(self, j: int, t: float):
        """Tightest active concurrent-capacity clamp, or None."""
        counters["checks"] += 1
        caps = [int(s.capacity) for s in self._on(j)
                if s.kind == "rate_limit" and s.active(t)]
        if not caps:
            return None
        counters["injected"] += 1
        return min(caps)

    def flake(self, j: int, t: float, key, salt) -> bool:
        """Does this request fail transiently at time ``t``?  The coin is
        keyed on (endpoint, request, attempt/step) so it is independent of
        event ordering and fresh on every retry."""
        counters["checks"] += 1
        p_ok = 1.0
        for s in self._on(j):
            if s.kind == "error_rate" and s.rate > 0.0 and s.active(t):
                p_ok *= 1.0 - float(s.rate)
        p_fail = 1.0 - p_ok
        if p_fail <= 0.0:
            return False
        hit = _u01(self.seed, int(j), int(key), int(salt)) < p_fail
        if hit:
            counters["injected"] += 1
        return hit
