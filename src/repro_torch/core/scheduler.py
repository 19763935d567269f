"""Serving scheduler: an event-driven simulation of the multi-LLM pool
(paper §4.2 setup) driven by the shared streaming control loop
(``repro_torch.core.control``), with straggler hedging and a failure plane.

The port of ``repro.core.scheduler``.  Each endpoint j serves up to L_j
concurrent jobs; the service time of a job is out_len / tokens_per_sec
(+ queueing).  Admission follows the paper's capacity rule
(:class:`~repro_torch.core.control.AdmissionRule`); "streaming" mode is
batching with batch size 1 (the paper's "common practice" strawman).  With
``cfg.arrival`` set, queries are released over time (Poisson / bursty /
diurnal — ``repro_torch.data.arrivals``) and ``cfg.streaming_dual`` routes
each window through the persistent dual controller
(``Policy.route_window``), so multipliers and the cumulative budget/α
ledger carry across windows and the live in-flight counts feed the
workload constraint.

The simulation itself is host code over NumPy; the device work is the
policy's (``OmniRouter`` predicts and solves on its predictor's device).

Hedging fires while the straggler is still *in flight*: whenever the clock
advances (admission or a completion), any un-hedged in-flight job whose
remaining time ``ft - t`` exceeds ``hedge_factor ×`` the median service
time is duplicated on the least-loaded endpoint.  The first finisher wins
and the sibling copy is cancelled (its capacity freed immediately).

The failure plane: a ``FaultPlan`` (``repro_torch.serving.faults``) takes
endpoints down, flakes requests, spikes latency and rate-limits capacity; a
failed attempt re-enters the arrival stream after an exponential backoff
while its retry budget lasts.  With ``cfg.health`` a
:class:`~repro_torch.core.health.HealthTracker` trips per-endpoint
breakers, which the controller folds into the loads and prices.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

import numpy as np

from repro_torch.data import arrivals
from repro_torch.data.qaserve import QAServe

from .baselines import Policy
from .control import AdmissionRule, ControlLoop, FoldBuffer, StreamController
from .health import HealthTracker


@dataclasses.dataclass
class SchedulerConfig:
    mode: str = "batching"          # batching | streaming (batch size 1)
    batch_size: int = 0             # 0 -> capacity/2 (paper's rule)
    loads: int = 4                  # L per model (paper default)
    tokens_per_sec: float = 60.0    # endpoint decode speed
    hedge: bool = False             # straggler mitigation: duplicate dispatch
    hedge_factor: float = 3.0       # hedge when remaining > factor x median
    fold_online: bool = False       # fold completions into the policy's store
    fold_chunk: int = 64            # completions per observe() flush
    seed: int = 0
    # --- streaming control plane ---
    arrival: str = "batch"          # batch | poisson | bursty | diurnal
    arrival_rate: float = 16.0      # mean arrivals / second
    window: float = 0.0             # min seconds between routing windows
    streaming_dual: bool = False    # carry DualState across windows
    horizon: int = 0                # expected stream length (0 -> ds.n)
    # --- failure plane ---
    fault_plan: Optional[object] = None  # serving.faults.FaultPlan (duck-
    #                                      typed: down/down_during/flake/
    #                                      latency_factor/rate_limit)
    health: bool = False            # per-endpoint circuit breakers + EWMAs
    health_cfg: Optional[object] = None  # core.health.HealthConfig override
    retry_budget: int = 2           # failed-request re-dispatches allowed
    backoff_s: float = 0.5          # retry k re-enters after backoff_s*2^k
    fail_frac: float = 0.5          # a flaking request errors after this
    #                                 fraction of its service time


@dataclasses.dataclass
class ServeResult:
    success_rate: float
    cost: float
    makespan: float
    scheduling_seconds: float
    llm_seconds: float              # total busy endpoint time
    per_model_counts: np.ndarray
    per_model_correct: np.ndarray
    per_model_cost: np.ndarray
    hedged: int = 0
    windows: int = 0                # routing windows the stream used
    dual_iters: int = 0             # total dual iterations (streaming_dual)
    failures: int = 0               # requests failed past their retry budget
    retries: int = 0                # failed attempts that re-entered the queue
    breaker_trips: int = 0          # circuit-breaker CLOSED/HALF_OPEN -> OPEN


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


def fold_completions(policy: Policy, ds_like, idxs) -> bool:
    """Fold completed requests back into the policy's predictor store
    (``policy.observe``) — the online half of the prediction plane.
    Returns True when something was folded: truth exists AND observe found
    a store to absorb it (observe returns the absorber, or None)."""
    obs = getattr(policy, "observe", None)
    if obs is None or len(idxs) == 0:
        return False
    correct = getattr(ds_like, "correct", None)
    out_len = getattr(ds_like, "out_len", None)
    if correct is None or out_len is None:
        return False            # a live engine without labels: nothing to fold
    idxs = np.asarray(idxs, int)
    return obs([ds_like.queries[i] for i in idxs], np.asarray(correct)[idxs],
               np.asarray(out_len)[idxs]) is not None


class _SimExecutor:
    """Event-driven fleet simulator behind the shared control loop: a heap
    of completion events, per-model in-flight counts, the hedging
    machinery and the failure plane.  Items are query indices into
    ``ds``."""

    def __init__(self, ds: QAServe, cfg: SchedulerConfig, loads: np.ndarray,
                 plan=None, health=None):
        self.ds = ds
        self.cfg = cfg
        self._loads = loads
        self._counts = np.zeros(ds.m, int)
        self.true_service = ds.out_len / cfg.tokens_per_sec  # (N, M) secs
        self.done_q: List = []             # (finish_time, event_id, qi, j)
        self.cancelled = set()             # event ids whose capacity is freed
        self.live: Dict[int, List] = {}    # qi -> [(eid, j, ft), ...]
        self.t = 0.0
        self.llm_secs = 0.0
        self.hedged = 0
        self.next_eid = 0
        self.assign = np.full(ds.n, -1, int)
        self.completed = np.zeros(ds.n, bool)
        self.hedged_q = np.zeros(ds.n, bool)
        self.service_seen: List[float] = []
        # the failure plane is dormant when plan and health are None: the
        # hot paths pay one ``is None`` each
        self.plan = plan
        self.health = health
        self.requeue = None                # bound by ControlLoop.__init__
        self.attempts = np.zeros(ds.n, int)
        self.failed_q = np.zeros(ds.n, bool)
        self.failures = 0
        self.retries = 0
        self._failed_eids = set()          # events that end in a flake error
        self._start: Dict[int, float] = {}  # eid -> dispatch time
        self._health_buf: List = []        # (j, ok, lat) awaiting flush

    # -- health event buffering -------------------------------------------
    # EWMA folds depend on order, so outcomes at one timestamp are buffered
    # and applied in one canonical sort whenever the clock moves strictly
    # forward: the breaker state must not depend on the pop order of
    # same-time events.
    def _record(self, j: int, ok: bool, lat):
        if self.health is not None:
            self._health_buf.append((int(j), bool(ok), lat))

    def flush_health(self):
        if self.health is not None and self._health_buf:
            for j, ok, lat in sorted(
                    self._health_buf,
                    key=lambda e: (e[0], e[1], -1.0 if e[2] is None else e[2])):
                self.health.record(j, ok, lat, now=self.t)
            self._health_buf.clear()

    def _set_time(self, t: float):
        # ANY strict advance moves the clock: ``_wake_at`` hands back
        # strictly-future deadlines, and refusing a sub-epsilon advance
        # would leave the loop spinning on a window timer that never
        # arrives.  Health events buffered at the old instant flush first.
        if t > self.t:
            self.flush_health()
            self.t = t

    # -- executor duck-type ----------------------------------------------------
    def now(self) -> float:
        return self.t

    def loads(self) -> np.ndarray:
        return self._loads

    def counts(self) -> np.ndarray:
        return self._counts

    def dispatch(self, items, x) -> List[int]:
        rejected = []
        x = np.asarray(x)
        for qi, j in zip(items, x):
            j = int(j)
            if self._counts[j] >= self._loads[j]:
                rejected.append(qi)     # no capacity after all -> requeue
                continue
            if self.health is not None and not self.health.admissible(j):
                rejected.append(qi)     # breaker open / probes exhausted
                continue
            if self.plan is not None:
                cap = self.plan.rate_limit(j, self.t)
                if cap is not None and self._counts[j] >= cap:
                    # 429: the endpoint sheds the request; it re-enters the
                    # ready queue (no retry charged) and health hears of it
                    self._record(j, False, None)
                    rejected.append(qi)
                    continue
                if self.plan.down(j, self.t):
                    # connect-time failure on a dead endpoint
                    self._record(j, False, None)
                    self._fail_attempt(qi)
                    continue
            self.assign[qi] = j
            self._dispatch(qi, j)
            if self.health is not None:
                self.health.note_admit(j)
        return rejected

    def advance(self, wake_at):
        if not self.done_q:
            if wake_at is None:
                return [], False
            self._set_time(wake_at)         # idle: jump to the next arrival
            return [], True
        if wake_at is not None and wake_at < self.done_q[0][0]:
            self._set_time(wake_at)         # arrival/window before completion
            return [], True
        # drain EVERY completion at this instant before handing control
        # back: an admission between two equal-time pops would route
        # against counts that depend on the pop order
        t_group = self.done_q[0][0]
        done: List[int] = []
        while self.done_q and self.done_q[0][0] <= t_group + 1e-12:
            done.extend(self._pop_completion())
        return done, True

    def _pop_completion(self) -> List[int]:
        ft, eid, qi, j = heapq.heappop(self.done_q)
        if eid in self.cancelled:           # sibling won; capacity was freed
            self.cancelled.discard(eid)
            self._failed_eids.discard(eid)
            self._start.pop(eid, None)
            self.live[qi] = [e for e in self.live.get(qi, []) if e[0] != eid]
            return []
        self._set_time(ft)
        start = self._start.pop(eid, ft)
        self._counts[j] -= 1
        self.live[qi] = [e for e in self.live.get(qi, []) if e[0] != eid]
        if eid in self._failed_eids:        # transient error fired mid-serve
            self._failed_eids.discard(eid)
            self._record(j, False, None)
            if not self.completed[qi] and not self.live.get(qi):
                self._fail_attempt(qi)      # no sibling left to save it
            return []
        if self.plan is not None and self.plan.down_during(j, start, ft):
            # the endpoint died while this request was in flight
            self._record(j, False, None)
            if not self.completed[qi] and not self.live.get(qi):
                self._fail_attempt(qi)
            return []
        self.service_seen.append(float(self.true_service[qi, j]))
        self._record(j, True, ft - start)
        if self.completed[qi]:
            return []
        self.completed[qi] = True
        self.assign[qi] = j                 # first finisher wins (hedging)
        for sid, sj, sft in self.live.get(qi, []):
            self.cancelled.add(sid)         # kill the straggler copy now
            self._counts[sj] -= 1
            self.llm_secs -= max(sft - self.t, 0.0)  # un-charge unexecuted tail
        self.live[qi] = []
        return [qi]

    def tick(self):
        self._maybe_hedge()

    # -- internals -------------------------------------------------------------
    def _dispatch(self, qi: int, j: int):
        self._counts[j] += 1
        dur = float(self.true_service[qi, j])
        eid = self.next_eid
        if self.plan is not None:
            dur *= self.plan.latency_factor(j, self.t)
            # transient error: the coin is a stateless hash of (endpoint,
            # query, attempt), so it is independent of event order and
            # re-flipped per retry; the slot is held for fail_frac of the
            # service time
            if self.plan.flake(j, self.t, qi, int(self.attempts[qi])):
                dur *= max(min(self.cfg.fail_frac, 1.0), 1e-3)
                self._failed_eids.add(eid)
        if self.plan is not None or self.health is not None:
            self._start[eid] = self.t
        self.llm_secs += dur
        heapq.heappush(self.done_q, (self.t + dur, eid, qi, j))
        self.live.setdefault(qi, []).append((eid, j, self.t + dur))
        self.next_eid += 1

    def _fail_attempt(self, qi: int):
        """A request attempt failed for real (no live sibling): retry with
        exponential backoff while budget remains, else mark it failed."""
        self.attempts[qi] += 1
        self.assign[qi] = -1
        if self.attempts[qi] <= self.cfg.retry_budget \
                and self.requeue is not None:
            self.retries += 1
            back = self.cfg.backoff_s * (2.0 ** (self.attempts[qi] - 1))
            self.requeue(qi, self.t + back)
        else:
            self.failed_q[qi] = True
            self.completed[qi] = True
            self.failures += 1

    def _hedge_scan(self):
        # ordering seam: events with one finish time have no inherent scan
        # order; a schedule race checker may permute this list to show the
        # outcome does not depend on it
        return list(self.done_q)

    def _maybe_hedge(self):
        """Duplicate un-hedged in-flight stragglers (remaining time vs the
        median service seen so far) on the least-loaded endpoint."""
        if not self.cfg.hedge or not self.service_seen:
            return
        med = float(np.median(self.service_seen))
        for ft, eid, qi, j in self._hedge_scan():
            if (eid in self.cancelled or self.completed[qi]
                    or self.hedged_q[qi]
                    or (ft - self.t) <= self.cfg.hedge_factor * med):
                continue
            if not np.any(self._counts < self._loads):
                return
            alt = int(np.argmax(self._loads - self._counts))
            if (self.health is not None
                    and not self.health.admissible(alt)):
                continue
            if alt != j and self._counts[alt] < self._loads[alt]:
                self.hedged_q[qi] = True
                self.hedged += 1
                self._dispatch(qi, alt)
                if self.health is not None:
                    self.health.note_admit(alt)


def run_serving(ds: QAServe, policy: Policy, cfg: SchedulerConfig
                ) -> ServeResult:
    """Simulate serving ``ds`` through ``policy`` under ``cfg``."""
    rng = np.random.RandomState(cfg.seed)
    n, m = ds.n, ds.m
    loads = np.full(m, cfg.loads, int)
    rule = AdmissionRule(
        1 if cfg.mode == "streaming" else cfg.batch_size).resolve(loads.sum())

    times = arrivals.make(cfg.arrival, n, rate=cfg.arrival_rate,
                          seed=cfg.seed)
    health = HealthTracker(m, cfg.health_cfg) if cfg.health else None
    executor = _SimExecutor(ds, cfg, loads, plan=cfg.fault_plan,
                            health=health)
    controller = StreamController(policy, horizon=cfg.horizon or n,
                                  stream=cfg.streaming_dual, rng=rng,
                                  health=health)
    fold = FoldBuffer(policy, lambda idxs: ds.subset(np.asarray(idxs, int)),
                      enabled=cfg.fold_online, chunk=cfg.fold_chunk)
    loop = ControlLoop(
        executor=executor, controller=controller, rule=rule,
        items=range(n), features=lambda idx: ds.subset(np.asarray(idx, int)),
        fold=fold, arrival_times=times, window=cfg.window,
        drain_admissions=True, requeue_front=False, health=health)
    loop.run()
    executor.flush_health()

    assign = executor.assign
    ok = assign >= 0
    idxs = np.flatnonzero(ok)
    cost_mat = ds.cost_matrix()
    # permanently-failed requests count against SR (a dropped query is a
    # wrong answer as far as the stream's alpha target is concerned)
    n_acc = len(idxs) + int(executor.failed_q.sum())
    sr = float(ds.correct[idxs, assign[idxs]].sum() / n_acc) if n_acc else 0.0
    total_cost = float(cost_mat[idxs, assign[idxs]].sum())
    pm_counts = np.bincount(assign[idxs], minlength=m)
    pm_correct = np.zeros(m)
    pm_cost = np.zeros(m)
    for j in range(m):
        mask = assign[idxs] == j
        if mask.any():
            pm_correct[j] = ds.correct[idxs[mask], j].mean()
            pm_cost[j] = cost_mat[idxs[mask], j].sum()
    return ServeResult(
        success_rate=sr, cost=total_cost, makespan=executor.t,
        scheduling_seconds=controller.route_seconds + fold.fold_seconds,
        llm_seconds=executor.llm_secs,
        per_model_counts=pm_counts, per_model_correct=pm_correct,
        per_model_cost=pm_cost, hedged=executor.hedged,
        windows=controller.windows,
        dual_iters=controller.dual_iters if cfg.streaming_dual else 0,
        failures=executor.failures, retries=executor.retries,
        breaker_trips=health.trips if health is not None else 0,
    )
