"""Arrival-process generators for the streaming control plane.

A NumPy copy of ``repro.data.arrivals``: the same seed gives the same
arrival times, bit for bit (``tests/test_torch_boundary.py`` holds the two
equal).

The serving stack is driven by *when queries arrive*, not by a batch
released at t=0: the control loop (``repro_torch.core.control``) releases
queries into the ready queue as the stream clock passes their arrival
time, and the windowed dual controller routes whatever has accumulated.
Three generator families cover the paper-adjacent evaluation regimes:

- ``poisson``  — memoryless baseline traffic (CV of inter-arrivals ≈ 1).
- ``bursty``   — a 2-state MMPP (Markov-modulated Poisson): traffic
  alternates between a quiet and a hot state, producing the bursty
  arrivals where capacity constraints actually bind (CV > 1).
- ``diurnal``  — inhomogeneous Poisson with a sinusoidal rate (thinning),
  the scaled-down shape of a day/night load curve.
- ``batch``    — everything at t=0; reproduces the pre-streaming behavior.

All generators return a sorted ``(n,)`` float64 vector of arrival times in
seconds.  ``window_slices`` groups a time vector into consecutive routing
windows of fixed width — the offline/bench view of what the control loop
does live.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np


def poisson(n: int, rate: float = 16.0, seed: int = 0) -> np.ndarray:
    """Homogeneous Poisson arrivals: exponential inter-arrival times at
    ``rate`` per second."""
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def bursty(n: int, rate: float = 16.0, burst: float = 5.0,
           p_switch: float = 0.05, seed: int = 0) -> np.ndarray:
    """2-state MMPP: a quiet state at ``rate / burst`` and a hot state at
    ``rate * burst``, switching with probability ``p_switch`` after each
    arrival.  Mean rate is of order ``rate``; the point is the variance —
    inter-arrival CV is well above 1, so queues build in bursts."""
    rng = np.random.RandomState(seed)
    hot = rng.rand() < 0.5
    gaps = np.empty(n)
    for i in range(n):
        r = rate * burst if hot else rate / burst
        gaps[i] = rng.exponential(1.0 / r)
        if rng.rand() < p_switch:
            hot = not hot
    return np.cumsum(gaps)


def diurnal(n: int, rate: float = 16.0, period: float = 120.0,
            depth: float = 0.8, seed: int = 0) -> np.ndarray:
    """Inhomogeneous Poisson via thinning: λ(t) = rate·(1 + depth·sin(2πt/
    period)) — a compressed day/night curve (``depth`` < 1 keeps λ > 0)."""
    rng = np.random.RandomState(seed)
    lam_max = rate * (1.0 + depth)
    times: List[float] = []
    t = 0.0
    while len(times) < n:
        t += rng.exponential(1.0 / lam_max)
        lam_t = rate * (1.0 + depth * np.sin(2.0 * np.pi * t / period))
        if rng.rand() < lam_t / lam_max:
            times.append(t)
    return np.asarray(times)


def batch(n: int, rate: float = 0.0, seed: int = 0) -> np.ndarray:
    """Everything arrives at t=0 (the pre-streaming, one-shot regime)."""
    return np.zeros(n)


GENERATORS = {"poisson": poisson, "bursty": bursty, "diurnal": diurnal,
              "batch": batch}


def make(kind: str, n: int, rate: float = 16.0, seed: int = 0,
         **kw) -> np.ndarray:
    """Dispatch by name — the scheduler/engine config entry point."""
    try:
        gen = GENERATORS[kind]
    except KeyError:
        raise ValueError(f"unknown arrival process {kind!r}; "
                         f"one of {sorted(GENERATORS)}") from None
    return gen(n, rate=rate, seed=seed, **kw)


def window_slices(times: np.ndarray, window: float) -> Iterator[np.ndarray]:
    """Group a sorted arrival-time vector into consecutive routing windows
    of width ``window`` seconds, yielding the (non-empty) index arrays in
    stream order.  ``window <= 0`` yields everything as one window."""
    times = np.asarray(times)
    n = len(times)
    if n == 0:
        return
    if window <= 0:
        yield np.arange(n)
        return
    start = np.floor(times[0] / window)
    buckets = (times / window - start).astype(int)
    lo = 0
    while lo < n:
        hi = int(np.searchsorted(buckets, buckets[lo], side="right"))
        yield np.arange(lo, hi)
        lo = hi
