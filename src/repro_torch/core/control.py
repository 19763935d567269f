"""Streaming control plane: the ONE admission / dispatch / completion loop
shared by the event-driven simulator (``repro_torch.core.scheduler.
run_serving``) and the serving engine
(``repro_torch.serving.engine.MultiLLMServer``).

The port of ``repro.core.control``:

- :class:`AdmissionRule` is the single home of the paper's §4.2 capacity
  rule.
- :class:`StreamController` owns the routing side of the stream: with
  ``stream=True`` it carries the :class:`~repro_torch.core.optimizer.DualState`
  across windows through ``Policy.route_window``; with ``stream=False`` it
  is the stateless one-shot ``Policy.route`` (``route_via_batch``).  An
  optional :class:`~repro_torch.core.health.HealthTracker` folds the
  breakers into the loads and reprices the cost column.
- :class:`AdaptiveWindow` widens or narrows the routing window from each
  window's solve cost and the backlog.
- :class:`FoldBuffer` is the buffered fold-back of completions into the
  policy's predictor store.
- :class:`ControlLoop` drives an *executor* (the simulator's event queue or
  the engine's endpoint pool) through release-arrivals → admit-window →
  advance; the simulator drains back-to-back admissions, the engine admits
  once a step and requeues rejected items at the front.

A policy that declares ``pads_windows`` (the port's ``OmniRouter``) gets
its streaming windows padded to power-of-two buckets (multiples of its
``window_multiple()``) with the padding masked by ``n_valid`` and sliced
off the returned assignment, as in the reference.  With ``ledgersan`` on
(``repro_torch.analysis.sanitize``), each streaming window's ledger is
checked for monotonicity on the host.

The executor duck-type:

    now() -> float                     stream clock (sim seconds / steps)
    loads() / counts() -> (M,) arrays  per-model capacity and in-flight
    dispatch(items, x) -> rejected     execute one routed window; return the
                                       items that found no capacity
    advance(wake_at) -> (done, bool)   move the clock one event/step; return
                                       completed items + progress flag.
                                       ``wake_at`` is the next time anything
                                       new can happen (arrival / window
                                       deadline) for idle clock jumps
    tick()                             post-event hook (hedging)
    stopped                            optional: True once a step budget is
                                       spent
    requeue                            optional: bound to the loop's
                                       ``push_pending`` (retries)
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.analysis import sanitize as _sanitize

from .baselines import Policy, pad_batch, pad_bucket
from .optimizer import DualState


@dataclasses.dataclass(frozen=True)
class AdmissionRule:
    """The paper §4.2 capacity rule, deduplicated out of the simulator and
    the engine: batch size and in-flight cap both default to half the
    pool's total concurrency."""

    batch_size: int = 0      # 0 -> cap_total // 2
    max_inflight: int = 0    # 0 -> cap_total // 2

    def resolve(self, cap_total: int) -> "AdmissionRule":
        half = max(1, int(cap_total) // 2)
        return AdmissionRule(self.batch_size or half,
                             self.max_inflight or half)

    def take(self, queued: int, inflight: int) -> int:
        """How many queries the next routing window may admit."""
        return max(0, min(self.batch_size, queued,
                          self.max_inflight - inflight))


class AdaptiveWindow:
    """Adaptive routing-window width: hold the routing overhead near a
    target (carried from the streaming PR's open item).

    Each routed window runs a dual solve whose cost shows up as that
    window's ``dual_iters``; the window width trades that overhead against
    admission latency.  After every window: a solve past ``target_iters``
    WIDENS the window (more queries amortize one solve), a cheap solve
    left with a backlog deeper than ``deep_queue`` NARROWS it (admission
    is falling behind a cheap router).  Width stays clamped to
    ``[lo, hi]``."""

    def __init__(self, window: float, *, lo: float = 1.0, hi: float = 64.0,
                 target_iters: int = 50, deep_queue: int = 16,
                 grow: float = 1.5, shrink: float = 2 / 3):
        if not (0 < lo <= window <= hi):
            raise ValueError(f"need 0 < lo <= window <= hi, got "
                             f"{lo} / {window} / {hi}")
        if not (shrink < 1.0 < grow):
            raise ValueError(f"need shrink < 1 < grow, got {shrink}/{grow}")
        self.window = float(window)
        self.lo = float(lo)
        self.hi = float(hi)
        self.target_iters = int(target_iters)
        self.deep_queue = int(deep_queue)
        self.grow = float(grow)
        self.shrink = float(shrink)
        self.widened = 0
        self.narrowed = 0

    def update(self, iters_run: int, queue_depth: int) -> float:
        """Fold one routed window's observed cost + backlog; returns the
        width the NEXT window should use."""
        if iters_run > self.target_iters:
            nxt = min(self.window * self.grow, self.hi)
            self.widened += int(nxt != self.window)
            self.window = nxt
        elif (iters_run < self.target_iters // 2
                and queue_depth > self.deep_queue):
            nxt = max(self.window * self.shrink, self.lo)
            self.narrowed += int(nxt != self.window)
            self.window = nxt
        return self.window


class StreamController:
    """Routing side of the stream: persistent dual state + horizon shares.

    One controller lives for the whole stream; each routed window updates
    ``state`` (multipliers + cumulative ledger) and the iteration/window
    counters used by the benchmarks.  ``horizon`` is the expected total
    stream length — window k's budget share is ``n_k / remaining``, so a
    stationary stream spreads the global budget evenly and under-spend
    rolls forward.  ``rng`` goes to every ``route`` / ``route_window`` call
    (the random and capacity-greedy baselines draw from it); ``health`` is
    an optional :class:`~repro_torch.core.health.HealthTracker`.
    """

    def __init__(self, policy: Policy, *, horizon: int = 0,
                 stream: bool = True, rng=None, health=None,
                 adapt_window: Optional[AdaptiveWindow] = None):
        self.policy = policy
        self.stream = stream
        self.horizon = int(horizon)
        self.rng = rng
        self.health = health
        self.adapt_window = adapt_window  # optional adaptive window sizing
        self.state: Optional[DualState] = None
        self.routed = 0
        self.windows = 0
        self.route_seconds = 0.0
        self._iters0 = int(getattr(policy, "dual_iters", 0))

    def route(self, ds_like, loads, counts) -> np.ndarray:
        """Build the RouteBatch from the admitted queries + LIVE fleet
        state and route it — the one admission/routing path shared by the
        simulator and the engine.

        Policies that declare ``pads_windows`` get their windows padded to
        power-of-two buckets (multiples of ``window_multiple()``); the
        padded rows are masked via ``n_valid`` and sliced off the returned
        assignment.

        Ledger caveat: ``route_window`` charges the ledger for every query
        it ROUTES; a query the executor then rejects (no capacity) and
        re-routes later would be charged twice.  A stateful policy that
        over-commits capacity would drift."""
        t0 = time.perf_counter()
        if self.health is not None:
            # breakers fold into the workload constraint (OPEN -> capacity
            # 0, HALF_OPEN -> probe slots); latency EWMAs reprice the cost
            # column (multiplier >= 1: the ledger only over-estimates)
            loads = self.health.effective_loads(loads)
        if self.stream:
            batch = ds_like.route_batch(
                np.asarray(loads, float), counts,
                with_truth=getattr(self.policy, "needs_truth", False))
            if self.health is not None:
                pm = self.health.price_multiplier()
                if np.any(pm != 1.0):
                    batch = dataclasses.replace(
                        batch,
                        price_in=(batch.price_in * pm).astype(
                            batch.price_in.dtype),
                        price_out=(batch.price_out * pm).astype(
                            batch.price_out.dtype))
            n_true = batch.n
            n_rem = max(self.horizon - self.routed, n_true)
            state_in = self.state
            if getattr(self.policy, "pads_windows", False):
                mult = getattr(self.policy, "window_multiple", lambda: 1)()
                batch = pad_batch(batch, pad_bucket(n_true, mult))
                x, self.state = self.policy.route_window(
                    batch, self.state, share=n_true / n_rem, rng=self.rng,
                    n_valid=n_true)
                x = np.asarray(x)[:n_true]
            else:
                x, self.state = self.policy.route_window(
                    batch, self.state, share=n_true / n_rem, rng=self.rng)
            if (_sanitize.active("ledgersan") and state_in is not None
                    and self.state is not None):
                _sanitize.check_state_monotone(state_in, self.state,
                                               where="StreamController")
            n_routed = n_true
        else:
            from .scheduler import route_via_batch
            x = route_via_batch(self.policy, ds_like, loads, counts,
                                rng=self.rng)
            n_routed = len(x)
        self.route_seconds += time.perf_counter() - t0
        self.routed += n_routed
        self.windows += 1
        return np.asarray(x).astype(int)

    @property
    def dual_iters(self) -> int:
        """Dual iterations run on THIS stream (policies accumulate across
        their lifetime; the baseline was captured at construction)."""
        return int(getattr(self.policy, "dual_iters", 0)) - self._iters0


class FoldBuffer:
    """Buffered online fold-back of completions into the policy's store
    (``fold_completions``).  ``features`` maps a list of completed items to
    a dataset-like with ``queries`` / ``correct`` / ``out_len`` (the same
    producer used for admission)."""

    def __init__(self, policy: Policy, features: Callable, *,
                 enabled: bool = False, chunk: int = 64):
        self.policy = policy
        self.features = features
        self.enabled = enabled
        self.chunk = max(1, chunk)
        self.buf: List = []
        self.folded = 0
        self.fold_seconds = 0.0

    def add(self, items: Sequence):
        if self.enabled:
            self.buf.extend(items)

    def flush(self, force: bool = False):
        if not self.enabled or not self.buf:
            return
        if not force and len(self.buf) < self.chunk:
            return
        from .scheduler import fold_completions
        t0 = time.perf_counter()
        if fold_completions(self.policy, self.features(self.buf),
                            np.arange(len(self.buf))):
            self.folded += len(self.buf)
        self.fold_seconds += time.perf_counter() - t0
        self.buf.clear()


class ControlLoop:
    """The shared admit→advance loop.

    ``items`` are opaque to the loop (the simulator uses query indices, the
    engine uses Requests); ``arrival_times`` releases them into the ready
    queue as the executor's clock passes each time (None = all at t=0).
    ``window`` > 0 rate-limits routing windows: a window fires when at
    least ``window`` clock units have passed since the last one OR a full
    batch has accumulated, so light traffic batches up instead of
    degenerating to per-query routing.

    ``drain_admissions`` is the caller's cadence: the simulator admits
    back-to-back windows while capacity lasts before processing the next
    completion; the engine interleaves one admission per decode step.
    ``requeue_front`` puts rejected items back at the FRONT of the ready
    queue, in order (the engine), instead of at its back (the simulator).
    ``fold`` (a :class:`FoldBuffer`) receives completed items; ``health``
    (a :class:`~repro_torch.core.health.HealthTracker`) gates admission
    and wakes the loop when a breaker's cooldown ends.
    """

    def __init__(self, *, executor, controller: StreamController,
                 rule: AdmissionRule, items: Sequence, features: Callable,
                 fold: FoldBuffer,
                 arrival_times: Optional[np.ndarray] = None,
                 window: float = 0.0, drain_admissions: bool = True,
                 requeue_front: bool = False, health=None):
        self.executor = executor
        self.controller = controller
        self.rule = rule
        self.features = features
        self.fold = fold
        self.window = float(window)
        self.drain_admissions = drain_admissions
        self.requeue_front = requeue_front
        self.health = health
        self._seq = itertools.count()
        items = list(items)
        if arrival_times is None:
            arrival_times = np.zeros(len(items))
        order = np.argsort(arrival_times, kind="stable")
        # min-heap of (time, tiebreak, item): equal-time entries pop in a
        # deterministic order whatever the insertion order (retries
        # requeued by the executor land here too)
        self.pending: list = [(float(arrival_times[i]), self._pkey(items[i]),
                               items[i]) for i in order]
        heapq.heapify(self.pending)
        self.ready: deque = deque()
        self._next_window = -np.inf
        if hasattr(executor, "requeue"):
            # failed-request re-entry: the executor hands (item, at) back
            # to the admission queue with its backoff-deferred release time
            executor.requeue = self.push_pending

    def _pkey(self, item):
        """Tiebreak of equal-time entries: a Request's ``rid`` or a plain
        int item (the simulator's query index), else insertion order."""
        rid = getattr(item, "rid", None)
        if rid is not None:
            return (0, int(rid))
        try:
            return (0, int(item))
        except (TypeError, ValueError):
            return (1, next(self._seq))

    def push_pending(self, item, at: float):
        """Re-enter ``item`` into the arrival stream at time ``at`` (a
        retry after a fault, with its backoff folded into ``at``)."""
        heapq.heappush(self.pending, (float(at), self._pkey(item), item))

    # -- stream bookkeeping ----------------------------------------------------
    def _release_arrivals(self):
        now = self.executor.now()
        while self.pending and self.pending[0][0] <= now + 1e-9:
            self.ready.append(heapq.heappop(self.pending)[2])

    def _wake_at(self) -> Optional[float]:
        """Next clock value at which something new can happen while the
        executor is otherwise idle: an arrival, a window deadline, or a
        breaker cooldown expiry.  Only STRICTLY FUTURE times count — a
        deadline already passed must not short-circuit the executor's own
        event processing (that would spin the loop without advancing)."""
        now = self.executor.now()
        wake = self.pending[0][0] if self.pending else None
        if (self.ready and self.window > 0 and self._next_window > now
                and (wake is None or self._next_window < wake)):
            wake = self._next_window
        if self.health is not None:
            hb = self.health.next_wake(now)
            if hb is not None and (wake is None or hb < wake):
                wake = hb
        return wake

    # -- one admission attempt -------------------------------------------------
    def _try_admit(self) -> bool:
        ex = self.executor
        if not self.ready:
            return False
        counts = np.asarray(ex.counts())
        loads = np.asarray(ex.loads())
        if self.health is not None:
            loads = self.health.effective_loads(loads)
        if not np.any(counts < loads):
            return False
        if (self.window > 0 and ex.now() < self._next_window
                and len(self.ready) < self.rule.batch_size):
            return False    # wait for the window timer (or a full batch)
        take = self.rule.take(len(self.ready), int(counts.sum()))
        if take <= 0:
            return False
        batch = [self.ready.popleft() for _ in range(take)]
        iters0 = self.controller.dual_iters
        x = self.controller.route(self.features(batch), loads, counts)
        aw = self.controller.adapt_window
        if aw is not None and self.window > 0:
            # widen/narrow the NEXT window from this one's solve cost and
            # the backlog it left behind
            self.window = aw.update(self.controller.dual_iters - iters0,
                                    len(self.ready))
        rejected = ex.dispatch(batch, x)
        if self.requeue_front:
            self.ready.extendleft(reversed(rejected))
        else:
            self.ready.extend(rejected)
        self._next_window = ex.now() + self.window
        ex.tick()
        # a fully-rejected batch is NOT admission progress: with
        # drain_admissions the loop would re-route the same batch against a
        # frozen clock forever; the executor advances to its next event
        # instead, and the items wait in ``ready`` for the next window
        return len(rejected) < len(batch)

    # -- the loop --------------------------------------------------------------
    def run(self):
        ex = self.executor
        self._release_arrivals()
        while self.ready or self.pending or ex.counts().sum() > 0:
            if getattr(ex, "stopped", False):
                break               # executor hit its hard step budget
            if self.health is not None:
                self.health.advance(ex.now())   # OPEN -> HALF_OPEN on expiry
            admitted = self._try_admit()
            if admitted and self.drain_admissions:
                continue
            done, progressed = ex.advance(self._wake_at())
            if done:
                self.fold.add(done)
                self.fold.flush()
            ex.tick()
            self._release_arrivals()
            if not progressed and not admitted:
                break               # deadlocked or out of steps: bail
        self.fold.flush(force=True)
        return self
