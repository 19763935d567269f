"""Schedule race checker for the port's control-loop executors.

The port of ``repro.analysis.sanitize.racecheck`` over the port's own
engine executor (``repro_torch.serving.engine._EngineExecutor``) and
simulator executor (``repro_torch.core.scheduler._SimExecutor``).

Same-timestamp events in the serving plane — chunk completions across the
pool, hedge fires, straggler cancellations, window deadlines — have no
inherent order; the engine picks one (list order, heap tiebreak by
dispatch id).  The design claims the outcome does not depend on that pick.
Seeded permuting executors reshuffle every same-timestamp ordering seam, a
harness runs the same scenario under several seeds, asserts per-run
end-state invariants (allocators drain, every request completes exactly
once, hedge bookkeeping empties, capacity counts never go negative), and
then asserts the routed outputs are identical across seeds.

Kept out of ``sanitize/__init__`` on purpose: importing it pulls in the
engine and the simulator.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import scheduler as _scheduler
from repro_torch.core.health import OPEN as _OPEN
from repro_torch.serving import engine as _engine


class RaceCheckError(AssertionError):
    """A schedule-order invariant was violated."""


def _check_no_open_admits(health, before, after):
    """A breaker in the OPEN state must never gain an in-flight request —
    not from routing, not from hedging, not from a fault retry."""
    if health is None:
        return
    for j, state in enumerate(health.breaker_state):
        if state == _OPEN and after[j] > before[j]:
            raise RaceCheckError(
                f"breaker admitted while OPEN: endpoint {j} went "
                f"{before[j]} -> {after[j]} in-flight with its breaker "
                f"tripped")


# -- permuting executors ------------------------------------------------------

class _PermutingEngineExecutor(_engine._EngineExecutor):
    """``_EngineExecutor`` with every same-timestamp ordering seam shuffled
    by a seeded RNG, plus the wake-at contract turned into a hard check."""

    rng: np.random.RandomState = None  # bound by _engine_executor_cls

    def advance(self, wake_at):
        now = self.now()
        if wake_at is not None and wake_at <= now:
            raise RaceCheckError(
                f"wake_at {wake_at} is not strictly future (now={now}): a "
                f"passed deadline makes the idle jump a no-op and the loop "
                f"spins forever (ControlLoop._wake_at contract)")
        return super().advance(wake_at)

    def _pool_order(self, k: int):
        return self.rng.permutation(k)

    def _completion_order(self, done):
        return [done[i] for i in self.rng.permutation(len(done))]

    def _hedge_candidates(self):
        cands = super()._hedge_candidates()
        return [cands[i] for i in self.rng.permutation(len(cands))]

    def _fault_candidates(self):
        # same-chunk flake/watchdog failures have no inherent sweep order
        cands = super()._fault_candidates()
        return [cands[i] for i in self.rng.permutation(len(cands))]

    def _active(self):
        return [ep.active_count() for ep in self.server.endpoints]

    def dispatch(self, items, x):
        before = self._active()
        out = super().dispatch(items, x)
        _check_no_open_admits(self.server.health, before, self._active())
        return out

    def tick(self):
        before = self._active()
        super().tick()          # hedging admits here
        _check_no_open_admits(self.server.health, before, self._active())


def _engine_executor_cls(rng: np.random.RandomState):
    return type("_SeededEngineExecutor", (_PermutingEngineExecutor,),
                {"rng": rng})


class _PermutingSimExecutor(_scheduler._SimExecutor):
    """``_SimExecutor`` whose completion-heap tiebreak ids come from a
    shuffled sequence instead of dispatch order, and whose hedge scan runs
    in random order — same-finish-time events pop differently per seed."""

    rng: np.random.RandomState = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # unique AND randomly ordered event ids: equal finish times break
        # ties in a seed-dependent order
        self._eid_seq = list(self.rng.permutation(1 << 16))
        type(self).created.append(self)

    def advance(self, wake_at):
        if wake_at is not None and wake_at <= self.t:
            raise RaceCheckError(
                f"wake_at {wake_at} is not strictly future (t={self.t})")
        out = self.advance_inner(wake_at)
        if (np.asarray(self._counts) < 0).any():
            raise RaceCheckError(
                "negative in-flight count: a hedge sibling returned "
                "capacity twice (double-counted completion/cancellation)")
        return out

    def advance_inner(self, wake_at):
        return super().advance(wake_at)

    def _dispatch(self, qi, j):
        if self._eid_seq:
            self.next_eid = int(self._eid_seq.pop())
        super()._dispatch(qi, j)

    def _hedge_scan(self):
        events = super()._hedge_scan()
        return [events[i] for i in self.rng.permutation(len(events))]

    def dispatch(self, items, x):
        before = np.asarray(self._counts).copy()
        out = super().dispatch(items, x)
        _check_no_open_admits(self.health, before, np.asarray(self._counts))
        return out

    def tick(self):
        before = np.asarray(self._counts).copy()
        super().tick()          # hedging admits here
        _check_no_open_admits(self.health, before, np.asarray(self._counts))


def _sim_executor_cls(rng: np.random.RandomState, created: list):
    return type("_SeededSimExecutor", (_PermutingSimExecutor,),
                {"rng": rng, "created": created})


# -- exploration harnesses ----------------------------------------------------

@dataclasses.dataclass
class RaceReport:
    seeds: tuple
    runs: int
    fingerprint: object   # the (identical) end-state across all seeds


def _engine_invariants(srv, done):
    if srv.queue:
        raise RaceCheckError(f"{len(srv.queue)} request(s) never served")
    if srv._hedges or srv._shadow_ids:
        raise RaceCheckError(
            f"hedge bookkeeping not drained: {len(srv._hedges)} pending "
            f"pair(s), {len(srv._shadow_ids)} live shadow(s)")
    seen = [r.rid for r in done]
    dupes = {rid for rid in seen if seen.count(rid) > 1}
    if dupes:
        raise RaceCheckError(
            f"request(s) {sorted(dupes)} completed more than once "
            f"(hedge sibling double-counted)")
    for k, ep in enumerate(srv.endpoints):
        if ep.active_count():
            raise RaceCheckError(
                f"endpoint {k} still has {ep.active_count()} active slot(s) "
                f"after drain")
        alloc = getattr(ep, "alloc", None)
        if alloc is None:
            continue
        if getattr(alloc, "san", None) is not None:
            alloc.san.assert_drained(ep)
        if len(alloc.free_slots) != alloc.n_slots \
                or len(alloc.free_pages) != alloc.n_pages - 1:
            raise RaceCheckError(
                f"endpoint {k} allocator not drained: "
                f"{len(alloc.free_slots)}/{alloc.n_slots} slots, "
                f"{len(alloc.free_pages)}/{alloc.n_pages - 1} pages free")


def explore_engine_schedules(make_server: Callable[[], tuple], *,
                             seeds: Sequence[int] = (0, 1, 2),
                             max_steps: int = 10_000) -> RaceReport:
    """Run one serving scenario under several event-order seeds.

    ``make_server()`` must return ``(server, route_features)`` with fresh
    :class:`Request` objects each call (endpoints may be reused — the drain
    invariants guarantee they come back pristine).
    """
    fingerprints = []
    for seed in seeds:
        srv, feats = make_server()
        srv._executor_cls = _engine_executor_cls(np.random.RandomState(seed))
        done = srv.run(feats, max_steps=max_steps)
        _engine_invariants(srv, done)
        fingerprints.append(tuple(sorted(
            (r.rid, r.done, getattr(r, "failed", False),
             tuple(r.output or ())) for r in done)))
        srv.completed = []
    if any(fp != fingerprints[0] for fp in fingerprints[1:]):
        raise RaceCheckError(
            f"routed outputs depend on same-timestamp event ordering: "
            f"{len(set(fingerprints))} distinct end states across seeds "
            f"{tuple(seeds)}")
    return RaceReport(seeds=tuple(seeds), runs=len(fingerprints),
                      fingerprint=fingerprints[0])


def explore_sim_schedules(make_args: Callable[[], tuple], *,
                          seeds: Sequence[int] = (0, 1, 2)) -> RaceReport:
    """Same exploration over the analytic simulator: ``make_args()`` returns
    ``(ds, policy, cfg)`` for :func:`repro_torch.core.scheduler.run_serving`."""
    fingerprints = []
    base = _scheduler._SimExecutor
    for seed in seeds:
        created: list = []
        _scheduler._SimExecutor = _sim_executor_cls(
            np.random.RandomState(seed), created)
        try:
            ds, policy, cfg = make_args()
            res = _scheduler.run_serving(ds, policy, cfg)
        finally:
            _scheduler._SimExecutor = base
        for ex in created:
            if (np.asarray(ex._counts) != 0).any():
                raise RaceCheckError(
                    f"in-flight counts not drained: {ex._counts.tolist()}")
            # cancellation is lazy: a cancelled sibling's heap entry may
            # legitimately outlive the run (its capacity was freed at
            # cancel time) — only NON-cancelled leftovers are a leak
            stale = [e for e in ex.done_q if e[1] not in ex.cancelled]
            if stale or any(ex.live.values()):
                raise RaceCheckError(
                    f"completion queue not drained: {len(stale)} live "
                    f"event(s) left behind")
            if not ex.completed.all():
                missing = int((~ex.completed).sum())
                raise RaceCheckError(f"{missing} query(ies) never completed")
        fingerprints.append((
            tuple(int(v) for ex in created for v in ex.assign),
            tuple(bool(f) for ex in created for f in ex.failed_q),
            float(round(res.cost, 9)),
        ))
    if any(fp != fingerprints[0] for fp in fingerprints[1:]):
        raise RaceCheckError(
            f"simulated routing depends on same-timestamp event ordering "
            f"across seeds {tuple(seeds)}")
    return RaceReport(seeds=tuple(seeds), runs=len(fingerprints),
                      fingerprint=fingerprints[0])
