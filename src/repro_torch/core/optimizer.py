"""ECCOS/OmniRouter constrained optimizer (paper §3.2, Appendix A) in PyTorch.

The port of ``repro.core.optimizer``: the one-shot solve, the threshold
sweeps (``solve_batch``, ``solve_grid``), the streaming window, the
blocked/masked window solve (``shards``, ``n_valid``) on one device or
sharded over the ranks of an active query mesh, and the legacy entry
points ``solve_assignment`` / ``solve_budget``.
Both modes share one code path through the unified parameterization

    scores_ij = A_ij + lam * B_ij + lam2_j,   feasible  ⇔  Σ B[i, x_i] <= t

(quality mode: (A, B, t) = (cost, -quality/N, -alpha); budget mode:
(A, B, t) = (-quality, cost, B)).  Dual subgradient ascent tracks the scalar
multiplier ``lam`` and the per-model workload multipliers ``lam2`` and keeps
the best feasible iterate.  On a CUDA tensor ``DualSolver.solve`` runs the
whole ascent in the hand-written kernel (``kernels.lagrangian_assign``); on a
CPU tensor it runs ``_solve_ref``, the plain ascent and the oracle.

The repair and polish passes are the JAX package's ``lax.while_loop``s, one
move per step.  Each step here is masked (a no-op once the loop's condition
is false, exactly as the JAX body never runs again), so the port runs
``chunk`` steps between host reads of the ``done`` flag — one host sync per
``chunk`` moves instead of one per move — and stays move-for-move identical
to the reference.

Streaming: a :class:`DualState` carries the multipliers and the cumulative
constraint ledger across arrival windows; ``route_window`` folds the ledger
into each window's effective threshold and warm-starts the ascent.

Float notes: a Python number divided BY a tensor is, in PyTorch, a
reciprocal times the number, and PyTorch's CPU float32 ``sqrt`` is not
correctly rounded; both would drift from the reference by an ulp, so every
such division takes two tensors and every root goes through ``sqrt32``.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.common import default_device, device_get
from repro_torch.kernels.lagrangian_assign.ref import (in_shard_order,
                                                       ordered_sum, sqrt32)

SYNC_EVERY = 32      # repair/polish moves between host reads of `done`

# host reads of a device flag made by the blocked solve's loop (none on the
# card: its loop is one launch); the repair/polish loops' reads are counted
# by ``repro_torch.common.guards.host_reads``, as every ``device_get``
solve_host_reads = 0


class SolveInfo(NamedTuple):
    """Uniform solver diagnostics — identical schema in both modes."""

    lam: torch.Tensor        # scalar constraint multiplier (λ1 / µ)
    lam_load: torch.Tensor   # (M,) per-model workload multipliers λ2
    feasible: torch.Tensor   # bool — some iterate satisfied all constraints
    cost: torch.Tensor       # Σ predicted $ of the returned assignment
    quality: torch.Tensor    # mean predicted quality of the returned assignment
    counts: torch.Tensor     # (M,) per-model counts of the returned assignment
    objective: torch.Tensor  # mode objective of returned x (cost | -Σ quality)
    iters_run: torch.Tensor  # int32 — dual iterations actually run


class DualState(NamedTuple):
    """Streaming dual-controller state carried across arrival windows."""

    lam: torch.Tensor           # () carried constraint multiplier (λ1 / µ)
    lam_load: torch.Tensor      # (M,) carried workload multipliers λ2
    budget_spent: torch.Tensor  # () cumulative $ routed so far (both modes)
    sr_deficit: torch.Tensor    # () cumulative Σ(α − q_chosen); >0 ⇒ behind α
    steps: torch.Tensor         # () cumulative dual iterations on this stream


def _f32(v, device) -> torch.Tensor:
    """``v`` as a float32 tensor on ``device``, with no host sync on the
    card: a tensor converts in place, a Python or NumPy scalar is filled on
    the device, an array is copied (never aliased: the caller's array may
    be read-only) and goes to the card by a pinned, non-blocking copy (a
    copy from pageable memory would wait for the stream)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    device = torch.device(device)
    if np.ndim(v) == 0:
        return torch.full((), float(v), dtype=torch.float32, device=device)
    a = torch.from_numpy(np.array(v, dtype=np.float32))
    if device.type == "cuda":
        return a.pin_memory().to(device, non_blocking=True)
    return a


def init_dual_state(m: int, device=None) -> DualState:
    """Fresh stream state: zero multipliers, empty ledger."""
    device = default_device(device)
    z = torch.zeros((), dtype=torch.float32, device=device)
    return DualState(lam=z, lam_load=torch.zeros(m, device=device),
                     budget_spent=z, sr_deficit=z, steps=z)


def fold_threshold(mode: str, threshold, state: Optional[DualState], n: int,
                   share=1.0):
    """This window's effective threshold given the stream ledger: budget
    mode spends ``share`` of the remaining budget; quality mode corrects α
    by the realized per-query deficit."""
    if state is None:
        return torch.as_tensor(threshold, dtype=torch.float32)
    dev = state.lam.device
    threshold = _f32(threshold, dev)
    if mode == "budget":
        remaining = torch.clamp(threshold - state.budget_spent, min=0.0)
        return remaining * _f32(share, dev)
    return torch.clamp(threshold + state.sr_deficit / _f32(n, dev), 0.0, 1.0)


def _mode_params(cost, quality, threshold, lr_con, *, budget_mode: bool,
                 n_eff=None):
    """Map (cost, quality, threshold) onto the unified (A, B, t, lr).

    ``n_eff`` (a masked window's valid-row count) replaces the row count in
    quality mode's 1/N scaling: padding rows must not dilute the mean."""
    if budget_mode:
        return -quality, cost, threshold, lr_con
    if n_eff is None:
        n = cost.shape[0]
        return cost, -quality / _f32(n, cost.device), -threshold, lr_con * n
    n = _f32(n_eff, cost.device)
    return cost, -quality / n, -threshold, lr_con * n


def _normalize_problem(a_mat, b_mat, t_eff, lr_con, lr_load, lam0, lam20,
                       loads):
    """Scale-free conditioning (the reference's ``_normalize_problem``):
    both unified matrices to unit mean magnitude, the λ step relative to
    the threshold, the λ2 step conditioned on the loads, and the warm-start
    multipliers converted into normalized units.  Returns the normalized
    problem plus (ā, b̄) for converting multipliers back."""
    dev = a_mat.device
    one, tiny = _f32(1.0, dev), _f32(1e-30, dev)
    a_bar = a_mat.abs().mean() + tiny
    b_bar = b_mat.abs().mean() + tiny
    a_mat = a_mat / a_bar
    b_mat = b_mat / b_bar
    t_eff = t_eff / b_bar
    lr_eff = _f32(lr_con, dev) / (one + t_eff.abs())
    lr_load_eff = _f32(lr_load, dev) / (one + loads.mean())
    lam0 = lam0 * b_bar / a_bar
    lam20 = lam20 / a_bar
    return a_mat, b_mat, t_eff, lr_eff, lr_load_eff, lam0, lam20, a_bar, b_bar


def _histogram(x, m: int, weights=None) -> torch.Tensor:
    """``torch.bincount(x, weights, minlength=m)`` as float32, made on the
    device with no host read (``bincount`` reads ``max(x)`` on the host to
    size its output).  The counts are integers, so the sum order of
    ``index_add_`` does not change them."""
    w = (torch.ones(x.shape, dtype=torch.float32, device=x.device)
         if weights is None else weights.float())
    return torch.zeros(m, dtype=torch.float32,
                       device=x.device).index_add_(0, x, w)


def _chosen_sum(mat, x):
    return mat.gather(1, x[:, None]).sum()


def _same(part):
    return part


def _shards_sum(v: torch.Tensor, gather=_same) -> torch.Tensor:
    """(lblocks, ...) per-shard values -> their sum over every shard: each
    shard's values in :func:`ordered_sum` order, then (``gather`` bringing
    in every rank's partials, in global shard order) the partials in shard
    order."""
    return in_shard_order(gather(ordered_sum(v.reshape(v.shape[0], -1))))


def _solve_ref(cost, quality, threshold, loads, lam0=0.0, lam20=None,
               stall_tol=0.0, step0=0.0, *, mode: str, iters: int,
               lr_con: float, lr_load: float, patience: int = 3,
               norm_grad: bool = False):
    """Plain dual ascent — the CPU path and the oracle for the kernel.

    ``lam0``/``lam20`` warm-start the multipliers and ``step0`` continues
    the step schedule 1/√(1+step0+t).  With ``stall_tol`` > 0 the loop exits
    once a feasible iterate is banked and ``patience`` iterations
    (cumulative) stalled the multipliers or sat on the constraint boundary.
    The loop condition is read on the host every iteration.
    """
    dev = cost.device
    n, m = cost.shape
    cost, quality, loads = cost.float(), quality.float(), loads.float()
    stall_tol, step0 = _f32(stall_tol, dev), _f32(step0, dev)
    a_mat, b_mat, t_eff, lr_eff = _mode_params(
        cost, quality, _f32(threshold, dev), lr_con,
        budget_mode=(mode == "budget"))
    lr_eff = _f32(lr_eff, dev)
    one = _f32(1.0, dev)
    a_bar = b_bar = one
    lam = _f32(lam0, dev).reshape(())
    lam2 = (torch.zeros(m, device=dev) if lam20 is None
            else _f32(lam20, dev).reshape(m))
    lr_load_eff = _f32(lr_load, dev)
    if norm_grad:
        (a_mat, b_mat, t_eff, lr_eff, lr_load_eff, lam, lam2,
         a_bar, b_bar) = _normalize_problem(
            a_mat, b_mat, t_eff, lr_con, lr_load, lam, lam2, loads)

    def assign(lam, lam2):
        return torch.argmin(a_mat + lam * b_mat + lam2[None, :], dim=1)

    best_a = _f32(float("inf"), dev)
    best_x = torch.zeros(n, dtype=torch.long, device=dev)
    found = torch.zeros((), dtype=torch.bool, device=dev)
    t = stall = 0
    while t < iters and stall < patience:
        x = assign(lam, lam2)
        asum, bsum = _chosen_sum(a_mat, x), _chosen_sum(b_mat, x)
        cnt = torch.bincount(x, minlength=m).float()
        feasible = (bsum <= t_eff) & torch.all(cnt <= loads)
        better = feasible & (asum < best_a)
        best_a = torch.where(better, asum, best_a)
        best_x = torch.where(better, x, best_x)
        found = found | feasible
        step = one / sqrt32(one + step0 + t)
        lam_new = torch.clamp(lam + lr_eff * step * (bsum - t_eff), min=0.0)
        lam2_new = torch.clamp(lam2 + lr_load_eff * step * (cnt - loads),
                               min=0.0)
        delta = (lam_new - lam).abs() + (lam2_new - lam2).abs().sum()
        denom = one + lam_new.abs() + lam2_new.abs().sum()
        resid = (bsum - t_eff).abs() / (one + t_eff.abs())
        stalled = found & ((delta < stall_tol * denom) | (resid < stall_tol))
        stall += int(stalled)      # cumulative — see the reference
        t += 1
        lam, lam2 = lam_new, lam2_new
    x_last = assign(lam, lam2)
    x = torch.where(found, best_x, x_last)
    info = SolveInfo(
        lam=lam * a_bar / b_bar, lam_load=lam2 * a_bar, feasible=found,
        cost=_chosen_sum(cost, x), quality=_chosen_sum(quality, x) / n,
        counts=torch.bincount(x, minlength=m).float(),
        objective=torch.where(found, best_a, _chosen_sum(a_mat, x_last))
        * a_bar,
        iters_run=torch.tensor(t, dtype=torch.int32, device=dev))
    return x, info


# --- device-resident post-solve feasibility pass ------------------------------

def _run_moves(step, carry, cap: int, chunk: int):
    """Apply the masked move ``step`` up to ``cap`` times (the reference's
    iteration cap), reading the carry's ``done`` flag (second to last, before
    the move count) on the host once every ``chunk`` steps.  Steps after
    ``done`` change nothing.  The read is explicit (``device_get``)."""
    k = 0
    while k < cap:
        for _ in range(min(chunk, cap - k)):
            carry = step(carry)
            k += 1
        if bool(device_get(carry[-2])):
            break
    return carry


def _valid_rows(n: int, n_valid, device):
    """(validr (n,) bool, its float32 weights) of a masked window's valid
    prefix, or (None, None) without a mask."""
    if n_valid is None:
        return None, None
    validr = torch.arange(n, device=device) < _f32(n_valid, device)
    return validr, validr.float()


def _at(t, i):
    """``t.flatten()[i]`` for a 0-dim index tensor, without a host sync."""
    return t.reshape(-1).gather(0, i.reshape(1)).reshape(())


def _moved(x, counts, i, j, do):
    """(x, counts) after moving query i to model j, where ``do``."""
    i1, j1 = i.reshape(1), j.reshape(1).to(x.dtype)
    x_new = x.scatter(0, i1, j1)
    # [-1.0, 1.0] made on the device (a host tensor would be a copy a move)
    step = torch.arange(-1.0, 2.0, 2.0, device=counts.device)
    counts_new = counts.index_add(0, torch.cat([x.gather(0, i1), j1]), step)
    return torch.where(do, x_new, x), torch.where(do, counts_new, counts)


def _record(stats, key, carry):
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(device_get(carry[-1]))


def repair_workload(x, cost, quality, loads, lam1=0.0, n_valid=None, *,
                    chunk: int = SYNC_EVERY, stats: Optional[dict] = None):
    """Enforce Σ_i x_ij <= L_j exactly by moving the cheapest-to-move
    queries off overloaded models: one move per step — the most overloaded
    model gives its lowest-regret query to that query's best free model.
    ``n_valid`` (a masked window) keeps the padding suffix out of the
    histogram and the move candidates.
    NumPy oracle: ``kernels.lagrangian_assign.ref.repair_workload_ref``.
    ``stats`` (optional dict) accumulates the moves made under
    ``"repair_moves"``."""
    dev = cost.device
    n, m = cost.shape
    x = torch.as_tensor(x, device=dev).long()
    cost, quality, loads = cost.float(), quality.float(), loads.float()
    reduced = cost - _f32(lam1, dev) * quality / _f32(n, dev)
    inf = _f32(float("inf"), dev)
    validr, vf = _valid_rows(n, n_valid, dev)
    counts0 = _histogram(x, m, vf)

    def step(carry):
        x, counts, done, moves = carry
        over = counts - loads
        j = torch.argmax(over)
        free = counts < loads
        alt = torch.where(free[None, :], reduced, inf)
        best_alt = torch.argmin(alt, dim=1)
        alt_min = alt.gather(1, best_alt[:, None])[:, 0]
        red_j = reduced.index_select(1, j.reshape(1))[:, 0]
        movable = (x == j) if validr is None else ((x == j) & validr)
        delta = torch.where(movable, alt_min - red_j, inf)
        qi = torch.argmin(delta)
        do = ~done & (_at(over, j) > 0) & torch.any(free)  # saturated: give up
        x, counts = _moved(x, counts, qi, _at(best_alt, qi), do)
        return x, counts, done | ~do, moves + do.int()

    carry = _run_moves(step, (x, counts0, torch.zeros((), dtype=torch.bool,
                                                      device=dev),
                              torch.zeros((), dtype=torch.int32, device=dev)),
                       n, chunk)
    _record(stats, "repair_moves", carry)
    return carry[0]


def _polish(x, cost, quality, loads, chunk, stats, tracked, init_sum,
            phase0_active, phase0_score, phase1_ok, phase1_minimize,
            validr=None, vf=None):
    """The two-phase greedy polish shared by both modes.  ``tracked`` is the
    matrix whose chosen-sum the phases steer by (quality or cost).  Phase 0
    takes the highest-scoring allowed move while ``phase0_active``; phase 1
    the lowest (``phase1_minimize``) or highest allowed move.  ``validr``
    (a masked window's valid rows, ``vf`` their float weights) keeps the
    padding out of the histogram and the move pool."""
    dev = cost.device
    n, m = cost.shape
    ninf = _f32(float("-inf"), dev)
    inf = _f32(float("inf"), dev)
    zero_b = torch.zeros((), dtype=torch.bool, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)

    def apply(carry, score, best, better_than):
        x, counts, tsum, done, moves = carry
        flat = best(score.reshape(-1))
        i, j = flat // m, flat % m
        do = ~done & better_than(_at(score, flat))
        tsum = torch.where(do, tsum + (_at(tracked, flat)
                                       - _at(tracked, i * m + _at(x, i))),
                           tsum)
        x, counts = _moved(x, counts, i, j, do)
        return x, counts, tsum, done | ~do, moves + do.int()

    def chosen(x):
        return (quality.gather(1, x[:, None]), cost.gather(1, x[:, None]))

    def allowed(ok):
        return ok if validr is None else ok & validr[:, None]

    def step0(carry):
        x, counts, tsum = carry[:3]
        curq, curc = chosen(x)
        ok, score = phase0_score(curq, curc, counts)
        ok = allowed(ok)
        score = torch.where(ok, score, ninf)
        carry = carry[:3] + (carry[3] | ~phase0_active(tsum),) + carry[4:]
        return apply(carry, score, torch.argmax, lambda s: s > ninf)

    def step1(carry):
        x, counts, tsum = carry[:3]
        curq, curc = chosen(x)
        ok, score = phase1_ok(curq, curc, counts, tsum)
        ok = allowed(ok)
        if phase1_minimize:
            return apply(carry, torch.where(ok, score, inf), torch.argmin,
                         lambda s: s < inf)
        return apply(carry, torch.where(ok, score, ninf), torch.argmax,
                     lambda s: s > ninf)

    counts0 = _histogram(x, m, vf)
    carry = _run_moves(step0, (x, counts0, init_sum, zero_b, zero_i),
                       4 * n, chunk)
    _record(stats, "polish_phase0_moves", carry)
    carry = _run_moves(step1, carry[:3] + (zero_b, zero_i), 8 * n, chunk)
    _record(stats, "polish_phase1_moves", carry)
    return carry[0]


def _masked_chosen_sum(mat, x, vf):
    if vf is None:
        return _chosen_sum(mat, x)
    # a masked window (the blocked solve): the device-independent order
    return ordered_sum(mat.gather(1, x[:, None])[:, 0] * vf)


def primal_polish(x, cost, quality, alpha, loads, n_valid=None, *,
                  chunk: int = SYNC_EVERY, stats: Optional[dict] = None):
    """Greedy primal improvement.  Phase 0 restores quality feasibility
    (best quality-gain-per-dollar moves); phase 1 is steepest-descent cost
    reduction within the quality slack and the free capacity.  ``n_valid``
    (a masked window) keeps the padding suffix out of the histogram, the
    quality target (nv·α, not n·α) and the move pool.
    NumPy oracle: ``...lagrangian_assign.ref.primal_polish_ref``."""
    dev = cost.device
    n, _ = cost.shape
    x = torch.as_tensor(x, device=dev).long()
    cost, quality, loads = cost.float(), quality.float(), loads.float()
    validr, vf = _valid_rows(n, n_valid, dev)
    nv = n if n_valid is None else n_valid
    target = _f32(nv, dev) * _f32(alpha, dev)
    floor = _f32(1e-9, dev)

    def phase0_score(curq, curc, counts):
        gain = quality - curq
        extra = cost - curc
        ok = (gain > 1e-12) & (counts[None, :] < loads[None, :])
        return ok, gain / torch.clamp(extra, min=floor)

    def phase1_ok(curq, curc, counts, qsum):
        slack = qsum - target
        delta = cost - curc                   # <0 == cheaper
        dq = quality - curq
        ok = ((delta < -1e-12) & (counts[None, :] < loads[None, :])
              & (dq >= -slack - 1e-12))
        return ok, delta

    return _polish(x, cost, quality, loads, chunk, stats, quality,
                   _masked_chosen_sum(quality, x, vf),
                   lambda qsum: qsum < target - 1e-9, phase0_score,
                   phase1_ok, phase1_minimize=True, validr=validr, vf=vf)


def budget_polish(x, cost, quality, budget, loads, n_valid=None, *,
                  chunk: int = SYNC_EVERY, stats: Optional[dict] = None):
    """Budget-mode primal improvement.  Phase 0 restores budget
    feasibility (least quality lost per dollar saved); phase 1 is steepest
    quality ascent within the remaining budget and the free capacity.
    ``n_valid`` (a masked window) keeps the padding suffix out of the
    histogram and the move pool.
    NumPy oracle: ``...lagrangian_assign.ref.budget_polish_ref``."""
    dev = cost.device
    x = torch.as_tensor(x, device=dev).long()
    cost, quality, loads = cost.float(), quality.float(), loads.float()
    validr, vf = _valid_rows(cost.shape[0], n_valid, dev)
    budget = _f32(budget, dev)
    floor = _f32(1e-9, dev)

    def phase0_score(curq, curc, counts):
        dq = quality - curq
        dc = cost - curc
        ok = (dc < -1e-12) & (counts[None, :] < loads[None, :])
        return ok, dq / torch.clamp(-dc, min=floor)

    def phase1_ok(curq, curc, counts, csum):
        dq = quality - curq
        dc = cost - curc
        ok = ((dq > 1e-12) & (counts[None, :] < loads[None, :])
              & (csum + dc <= budget + 1e-9))
        return ok, dq

    return _polish(x, cost, quality, loads, chunk, stats, cost,
                   _masked_chosen_sum(cost, x, vf),
                   lambda csum: csum > budget + 1e-9, phase0_score,
                   phase1_ok, phase1_minimize=False, validr=validr, vf=vf)


def brute_force(cost: np.ndarray, quality: np.ndarray, threshold: float,
                loads: np.ndarray, mode: str = "quality"
                ) -> Optional[np.ndarray]:
    """Exact solver for tiny instances (test oracle), both modes."""
    n, m = cost.shape
    best, best_obj = None, np.inf
    for x in itertools.product(range(m), repeat=n):
        x = np.array(x)
        if np.any(np.bincount(x, minlength=m) > loads):
            continue
        q = quality[np.arange(n), x].mean()
        c = cost[np.arange(n), x].sum()
        if mode == "quality":
            if q < threshold:
                continue
            obj = c
        else:
            if c > threshold:
                continue
            obj = -q * n
        if obj < best_obj:
            best, best_obj = x, obj
    return best


# --- blocked / masked window solve ---------------------------------------------
#
# The only cross-query coupling in the dual ascent is the per-iteration
# reduction [ΣA, ΣB, histogram].  ``shards`` turns it into a BLOCKED one:
# the (N, M) problem is viewed as (S, N/S, M), each shard produces its
# contiguous partial sums, and the partials combine in shard order; the
# whole ascent is ``ops.blocked_dual_ascent`` (one launch of the cluster
# kernel on the card, the plain loop over ``shard_stats_ref`` on the CPU).
# Repair and polish run shard-locally against an exact integer partition
# of the capacity vector.  The same path carries the masked window:
# ``n_valid`` marks the valid-row prefix of a padded window; padding rows
# are zeroed out of every matrix, masked out of every histogram and
# excluded from repair/polish moves, so they never touch the ledger.
#
# Under an active query mesh (``common.sharding.query_axis_info``) the same
# core runs on every rank over its ``lblocks = gshards / ranks`` contiguous
# local shards, whose global ids start at ``rank · lblocks``.  Every
# cross-shard sum goes through one hook, ``gather``: the ordered all-gather
# of the local per-shard partials (rank-major, so global shard order), after
# which every rank applies the same ``in_shard_order``.  So the sharded
# solve walks the one-rank blocked solve's trajectory bit for bit: the
# prologue's sums, each iteration's [ΣA, ΣB, histogram] (the ascent is
# ``ref.blocked_dual_ascent_ref``'s loop with the shard-statistics op and
# the hook; one rank takes the one-launch cluster kernel instead), the
# chosen sums and the final ``x``, all-gathered so every rank returns the
# whole window, as the reference's ``out_specs`` do.

def _shard_quotas(loads, shard_ids, gshards: int):
    """Exact integer partition of per-model capacity across query shards:
    quota_j(s) = floor(L_j·(s+1)/S) − floor(L_j·s/S)."""
    dev = loads.device
    s = shard_ids.float()[:, None]
    g = _f32(gshards, dev)
    hi = torch.floor(loads[None, :] * ((s + 1.0) / g))
    lo = torch.floor(loads[None, :] * (s / g))
    return torch.where(torch.isfinite(loads)[None, :], hi - lo,
                       loads[None, :])


def _blocked_prologue(a_mat, b_mat, t_eff, loads, lr_eff, lr_load_eff, lam0,
                      lam20, n_valid, *, lblocks: int, norm_grad: bool,
                      lr_con: float, lr_load: float, d0: int = 0,
                      gather=_same):
    """The problem the blocked ascent runs on: the per-shard valid-row
    counts ``nv_loc`` of the local shards ``d0 … d0 + lblocks - 1`` (the
    padding is a suffix of the window) and, with ``norm_grad``, the
    scale-free conditioning.  Returns (a_mat, b_mat, nv_loc, t_eff, lr_eff,
    lr_load_eff, lam0, lam20, a_bar, b_bar)."""
    dev = a_mat.device
    nloc, m = a_mat.shape
    nl = nloc // lblocks
    one, tiny = _f32(1.0, dev), _f32(1e-30, dev)
    shard_ids = d0 + torch.arange(lblocks, device=dev)
    nv_loc = torch.clamp(n_valid - shard_ids.float() * nl, 0.0, float(nl))
    a_bar = b_bar = one
    if norm_grad:
        denom = n_valid * _f32(m, dev) + tiny
        a_bar = _shards_sum(a_mat.reshape(lblocks, nl, m).abs(),
                            gather) / denom + tiny
        b_bar = _shards_sum(b_mat.reshape(lblocks, nl, m).abs(),
                            gather) / denom + tiny
        a_mat, b_mat = a_mat / a_bar, b_mat / b_bar
        t_eff = t_eff / b_bar
        lr_eff = _f32(lr_con, dev) / (one + t_eff.abs())
        lr_load_eff = _f32(lr_load, dev) / (one + ordered_sum(loads)
                                             / _f32(m, dev))
        lam0 = lam0 * b_bar / a_bar
        lam20 = lam20 / a_bar
    return (a_mat.contiguous(), b_mat.contiguous(), nv_loc, t_eff, lr_eff,
            lr_load_eff, _f32(lam0, dev).reshape(()),
            _f32(lam20, dev).reshape(m), a_bar, b_bar)


def _blocked_window_core(a_mat, b_mat, cost, quality, t_eff, p_eff, loads,
                         lr_eff, lr_load_eff, lam0, lam20, stall_tol, step0,
                         n_valid, *, mode: str, iters: int, patience: int,
                         lblocks: int, polish: bool, norm_grad: bool,
                         lr_con: float, lr_load: float,
                         gshards: int, d0: int, gather,
                         stats: Optional[dict] = None):
    """Dual ascent (+ optional repair/polish + ledger sums) over ``lblocks``
    local query shards (global ids ``d0 …``) of ``gshards``, on the
    tensors' device; ``gather`` is None when the local shards are all.  Returns (this rank's x (N_loc,),
    SolveInfo, final csum, final qsum); everything but x is replicated.

    Without ``gather`` the whole ascent is one call of
    ``ops.blocked_dual_ascent``: one launch of the cluster kernel on the
    card (no host read), the plain loop on the CPU (a host read every
    ``ref.SYNC_EVERY`` iterations).  With it (a query mesh) the ascent is
    ``ref.blocked_dual_ascent_ref``'s loop over ``ops.shard_stats`` (one
    launch of the shard-statistics kernel an iteration on the card) and the
    hook.  All keep the reference's semantics (stall early exit,
    ``iters_run`` exact) and give the same bits."""
    global solve_host_reads
    from repro_torch.kernels.lagrangian_assign import ops
    from repro_torch.kernels.lagrangian_assign.ref import (
        blocked_dual_ascent_ref)
    dev = a_mat.device
    nloc, m = a_mat.shape
    nl = nloc // lblocks
    hook = _same if gather is None else gather
    (a_mat, b_mat, nv_loc, t_eff, lr_eff, lr_load_eff, lam0, lam20, a_bar,
     b_bar) = _blocked_prologue(a_mat, b_mat, t_eff, loads, lr_eff,
                                lr_load_eff, lam0, lam20, n_valid,
                                lblocks=lblocks, norm_grad=norm_grad,
                                lr_con=lr_con, lr_load=lr_load, d0=d0,
                                gather=hook)
    shard_ids = d0 + torch.arange(lblocks, device=dev)
    rows = torch.arange(nl, device=dev)
    valid2 = rows[None, :] < nv_loc.long()[:, None]           # (S, nl)
    cols = torch.arange(m, device=dev)
    c3 = cost.reshape(lblocks, nl, m)
    q3 = quality.reshape(lblocks, nl, m)
    a3 = a_mat.reshape(lblocks, nl, m)
    b3 = b_mat.reshape(lblocks, nl, m)

    def onehot(x2):
        return ((x2[..., None] == cols) & valid2[..., None]).float()

    def chosen(mat3, x2):
        vals = mat3.gather(2, x2[..., None])[..., 0]
        return _shards_sum(torch.where(valid2, vals, 0.0), hook)

    t0 = time.perf_counter()
    args = (a_mat, b_mat, nv_loc, t_eff, lr_eff, lr_load_eff, lam0, lam20,
            stall_tol, step0, loads)
    if gather is None:
        out, reads = ops.blocked_dual_ascent(*args, iters=iters,
                                             patience=patience)
    else:
        out, reads = blocked_dual_ascent_ref(*args, iters=iters,
                                             patience=patience,
                                             stats=ops.shard_stats,
                                             gather=gather)
    solve_host_reads += reads
    lam, lam_b, best_a = out[0], out[1], out[2]
    found = out[3] > 0.0
    t_run = out[6].to(torch.int32)
    lam2, lam2_b = out[8:8 + m], out[8 + m:8 + 2 * m]

    lam_sel = torch.where(found, lam_b, lam)
    lam2_sel = torch.where(found, lam2_b, lam2)
    x2 = torch.argmin(a3 + lam_sel * b3 + lam2_sel.reshape(1, 1, m), dim=2)
    asum_e = chosen(a3, x2)
    info = SolveInfo(
        lam=lam * a_bar / b_bar, lam_load=lam2 * a_bar, feasible=found,
        cost=chosen(c3, x2),
        quality=chosen(q3, x2) / torch.clamp(n_valid, min=1.0),
        counts=in_shard_order(hook(onehot(x2).sum(dim=1))),
        objective=torch.where(found, best_a, asum_e) * a_bar,
        iters_run=t_run)
    if stats is not None:
        _sync(dev)
        t1 = time.perf_counter()
        stats["solve_s"] = stats.get("solve_s", 0.0) + t1 - t0

    if polish:
        quotas = _shard_quotas(loads, shard_ids, gshards)
        lam1 = (lam * a_bar / b_bar if mode == "quality"
                else torch.zeros((), device=dev))
        shares = p_eff * nv_loc / torch.clamp(n_valid, min=1.0)
        xs = []
        for s in range(lblocks):
            x1 = repair_workload(x2[s], c3[s], q3[s], quotas[s], lam1,
                                 nv_loc[s], stats=stats)
            if mode == "quality":
                x1 = primal_polish(x1, c3[s], q3[s], p_eff, quotas[s],
                                   nv_loc[s], stats=stats)
            else:
                # each shard polishes toward its valid-row budget share
                x1 = budget_polish(x1, c3[s], q3[s], shares[s], quotas[s],
                                   nv_loc[s], stats=stats)
            xs.append(x1)
        x2 = torch.stack(xs)
        if stats is not None:
            _sync(dev)
            stats["polish_s"] = (stats.get("polish_s", 0.0)
                                 + time.perf_counter() - t1)
    return x2.reshape(nloc), info, chosen(c3, x2), chosen(q3, x2)


def _blocked_window(cost, quality, threshold, loads, lam0, lam20, stall_tol,
                    step0, n_valid, p_eff, *, mode: str, iters: int,
                    lr_con: float, lr_load: float, patience: int,
                    norm_grad: bool, gshards: int, polish: bool,
                    stats: Optional[dict] = None, ranks: int = 1,
                    rank: int = 0, group=None):
    """The reference's ``_blocked_window_fn``: zero the padding rows, map
    onto the unified problem with the valid-row count, and run
    :func:`_blocked_window_core` over ``gshards`` shards.  With ``group``
    (a query mesh of ``ranks``), cost/quality are this rank's rows, the
    ``rank``-th contiguous slice of the window, and the returned x is the
    whole window, all-gathered."""
    dev = cost.device
    n, m = cost.shape
    lblocks = gshards // ranks
    gather = None
    if group is not None:
        from repro_torch.launch.mesh import all_gather

        def gather(part):
            return all_gather(part, group)
    nvf = _f32(n_valid, dev)
    # padding rows (a suffix) contribute exactly 0.0 to every reduction,
    # the stream ledger included
    validr = ((torch.arange(n, device=dev) + rank * n) < nvf)[:, None]
    cost = cost.float() * validr
    quality = quality.float() * validr
    a_mat, b_mat, t_eff, lr_eff = _mode_params(
        cost, quality, _f32(threshold, dev), lr_con,
        budget_mode=(mode == "budget"), n_eff=nvf)
    out = _blocked_window_core(
        a_mat, b_mat, cost, quality, t_eff, _f32(p_eff, dev),
        loads.float(), _f32(lr_eff, dev), _f32(lr_load, dev),
        _f32(lam0, dev), _f32(lam20, dev).reshape(m), _f32(stall_tol, dev),
        _f32(step0, dev), nvf, mode=mode, iters=iters, patience=patience,
        lblocks=lblocks, polish=polish, norm_grad=norm_grad, lr_con=lr_con,
        lr_load=lr_load, stats=stats, gshards=gshards, d0=rank * lblocks,
        gather=gather)
    if gather is None:
        return out
    x, info, csum, qsum = out
    return gather(x), info, csum, qsum


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class DualSolver:
    """One dual solver for both routing modes.

    mode="quality": min cost s.t. mean quality >= threshold.
    mode="budget":  max quality s.t. total cost <= threshold.

    The device decides the solve: on a CUDA tensor the whole ascent runs in
    the hand-written kernel (``kernels.lagrangian_assign.ops.solve_fused``),
    on a CPU tensor in ``_solve_ref``.  Tensor inputs stay on their device;
    anything else (NumPy arrays, lists) goes to ``device``, which is CUDA
    unless the caller names one (``device="cpu"``).  ``use_kernel`` is kept
    so configs read as they do for the JAX package; it selects nothing.

    ``shards`` > 1, or a masked window (``n_valid``), takes the blocked
    solve (:func:`_blocked_window_core`): every shard on the one device,
    the whole ascent through ``ops.blocked_dual_ascent`` (one kernel
    launch on the card).  Under an active query mesh
    (``common.sharding.use_mesh(query_mesh(), query_rules())`` on every
    rank of a ``torch.distributed`` world) every solve is blocked and
    sharded (``_plan``): each rank runs its contiguous shards, one
    shard-statistics launch an iteration on the card, and every rank
    returns the whole window, bit for bit the one-rank blocked solve's.
    The caller passes every rank the whole window, or, with ``local=True``
    (``route_arrays``, ``route_window``), each rank its own rows.
    """

    mode: str = "quality"          # "quality" | "budget"
    iters: int = 150
    lr_constraint: float = 4.0     # α1 (quality) / µ step (budget, use ~50)
    lr_workload: float = 0.5       # α2 in Eq. 10
    use_kernel: bool = False       # kept for config parity; the device decides
    stall_tol: float = 0.0         # >0: early-exit on multiplier stall
    stall_patience: int = 3        # cumulative stalled iters before exit
    norm_grad: bool = False        # scale-free subgradient (streaming)
    shards: int = 1                # blocked stats reduction over the query
    #                                axis; under a query mesh of D ranks
    #                                1 adopts D, else a multiple of D
    robust: bool = False           # route_window solves against the quality
    #                                lower-confidence bound q - kappa*sigma
    kappa: float = 1.0             # LCB width (0 == bit-identical to robust
    #                                off: q - 0*sigma is exact for finite
    #                                sigma)
    device: Optional[str] = None   # where non-tensor inputs go; None = CUDA

    def __post_init__(self):
        if self.mode not in ("quality", "budget"):
            raise ValueError(f"unknown solver mode: {self.mode!r}")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1: {self.shards}")
        if self.kappa < 0.0:
            raise ValueError(f"kappa must be >= 0: {self.kappa}")

    @staticmethod
    def _check_divisible(n: int, gshards: int):
        if n % gshards:
            raise ValueError(
                f"window size {n} does not divide into {gshards} query "
                f"shards — pad the window (StreamController pads to "
                f"power-of-two buckets and passes n_valid)")

    def _plan(self):
        """(mesh, axes, global shard count) honouring an active query mesh.

        No mesh (or no "query" rule): blocked execution on one device with
        ``self.shards`` blocks.  An active query mesh of D ranks: the shard
        count adopts D (when ``shards`` is 1) or must be a multiple of it;
        each rank then runs shards/D contiguous blocks."""
        from repro_torch.common.sharding import query_axis_info
        qa = query_axis_info()
        if qa is None:
            return None, None, self.shards
        mesh, axes, d = qa
        gsh = self.shards if self.shards > 1 else d
        if gsh % d:
            raise ValueError(
                f"DualSolver.shards={gsh} must be a multiple of the active "
                f"query-mesh size {d}")
        return mesh, axes, gsh

    def _rows(self, n: int, local: bool):
        """(plan, the window's global row count) of a call whose tensors
        hold ``n`` rows: the whole window, or this rank's rows."""
        plan = self._plan()
        if not local:
            return plan, n
        if plan[0] is None:
            raise ValueError("local=True needs an active query mesh")
        return plan, n * plan[0].axis_size(plan[1])

    def _blocked(self, plan, n_valid, n: int) -> bool:
        """Whether a call takes the blocked path (checking divisibility of
        the global row count ``n``)."""
        mesh, _, gsh = plan
        if mesh is not None or gsh > 1 or n_valid is not None:
            self._check_divisible(n, gsh)
            return True
        return False

    def _warm(self, state, m, dev):
        """(lam0, lam20, step0) from a carried state, or a cold start."""
        if state is None:
            return (_f32(0.0, dev), torch.zeros(m, device=dev),
                    _f32(0.0, dev))
        # continue the stream's step schedule with a floor of ~1/20
        return state.lam, state.lam_load, torch.clamp(state.steps, max=400.0)

    def _blocked_call(self, cost, quality, threshold, loads, state, n_valid,
                      p_eff, plan, n: int, *, polish: bool, stats=None):
        """The blocked solve of an n-row window; under a query mesh each
        rank takes its rows of cost/quality unless they hold only those."""
        mesh, axes, gsh = plan
        m = cost.shape[1]
        lam0, lam20, step0 = self._warm(state, m, cost.device)
        kw = {}
        if mesh is not None:
            ranks, rank = mesh.axis_size(axes), mesh.axis_index(axes)
            rows = n // ranks
            if cost.shape[0] == n:
                cost = cost[rank * rows:(rank + 1) * rows]
                quality = quality[rank * rows:(rank + 1) * rows]
            kw = dict(ranks=ranks, rank=rank, group=mesh.group(axes))
        return _blocked_window(
            cost, quality, threshold, loads, lam0, lam20, self.stall_tol,
            step0, n if n_valid is None else n_valid, p_eff, mode=self.mode,
            iters=self.iters, lr_con=self.lr_constraint,
            lr_load=self.lr_workload, patience=self.stall_patience,
            norm_grad=self.norm_grad, gshards=gsh, polish=polish,
            stats=stats, **kw)

    def _inputs(self, cost, quality, loads):
        dev = (cost.device if isinstance(cost, torch.Tensor)
               else default_device(self.device))
        return _f32(cost, dev), _f32(quality, dev), _f32(loads, dev)

    def solve(self, cost, quality, threshold, loads,
              state: Optional[DualState] = None, n_valid=None
              ) -> Tuple[torch.Tensor, SolveInfo]:
        """cost/quality (N, M) -> (assignment (N,), SolveInfo).  ``state``
        warm-starts the ascent from a previous window's multipliers;
        ``n_valid`` marks the valid-row prefix of a padded window."""
        cost, quality, loads = self._inputs(cost, quality, loads)
        plan, n = self._rows(cost.shape[0], False)
        if self._blocked(plan, n_valid, n):
            x, info, _, _ = self._blocked_call(
                cost, quality, threshold, loads, state, n_valid, threshold,
                plan, n, polish=False)
            return x, info
        return self._solve_whole(cost, quality, threshold, loads, state)

    def _solve_whole(self, cost, quality, threshold, loads, state=None):
        """The one-shot (unblocked) solve of device tensors: the fused
        kernel on the card, ``_solve_ref`` on the CPU."""
        dev = cost.device
        m = cost.shape[1]
        lam0, lam20, step0 = self._warm(state, m, dev)
        kw = dict(mode=self.mode, iters=self.iters, lr_con=self.lr_constraint,
                  lr_load=self.lr_workload, patience=self.stall_patience,
                  norm_grad=self.norm_grad)
        if dev.type == "cuda":
            from repro_torch.kernels.lagrangian_assign.ops import solve_fused
            return solve_fused(cost, quality, threshold, loads, lam0=lam0,
                               lam20=lam20, step0=step0,
                               stall_tol=self.stall_tol, **kw)
        if dev.type != "cpu":
            raise ValueError(f"no dual solve for device {dev}")
        return _solve_ref(cost, quality, threshold, loads, lam0, lam20,
                          self.stall_tol, step0, **kw)

    def solve_batch(self, cost, quality, thresholds, loads
                    ) -> Tuple[torch.Tensor, SolveInfo]:
        """Independent cold solves over a leading batch axis: cost/quality
        (B, N, M), thresholds (B,), loads (M,) or (B, M).  Returns x (B, N)
        and a ``SolveInfo`` whose fields carry the batch axis.

        The JAX package vmaps its reference; ``torch.vmap`` cannot take the
        ascent's data-dependent exit, so this loops over the batch, each
        element the one-shot solve on its device (the fused kernel on the
        card, ``_solve_ref`` on the CPU; ``shards`` is not used): element
        b equals ``solve`` on element b bit for bit."""
        cost, quality, loads = self._inputs(cost, quality, loads)
        thr = _f32(thresholds, cost.device).reshape(-1)
        if loads.dim() == 1:
            loads = loads.expand(cost.shape[0], -1)
        return self._stack([self._solve_whole(cost[b], quality[b], thr[b],
                                              loads[b])
                            for b in range(cost.shape[0])])

    def solve_grid(self, cost, quality, thresholds, loads
                   ) -> Tuple[torch.Tensor, SolveInfo]:
        """A (K,) grid of alpha/budget thresholds over one instance
        (cost/quality (N, M)): x (K, N) and a ``SolveInfo`` with a leading
        K axis; element k equals ``solve`` at threshold k bit for bit."""
        cost, quality, loads = self._inputs(cost, quality, loads)
        thr = _f32(thresholds, cost.device).reshape(-1)
        return self._stack([self._solve_whole(cost, quality, t, loads)
                            for t in thr])

    @staticmethod
    def _stack(results):
        xs, infos = zip(*results)
        return torch.stack(xs), SolveInfo(*(torch.stack(f)
                                            for f in zip(*infos)))

    def route_arrays(self, cost, quality, threshold, loads,
                     polish_threshold=None,
                     state: Optional[DualState] = None, n_valid=None,
                     stats: Optional[dict] = None, local: bool = False
                     ) -> Tuple[torch.Tensor, SolveInfo]:
        """Solve -> workload repair -> primal (or budget) polish.

        ``stats`` (optional dict) receives ``solve_s`` and ``polish_s``
        (device-synchronized wall seconds) and the move counts.
        ``local`` (a query mesh only): cost/quality are this rank's rows;
        x is still the whole window."""
        cost, quality, loads = self._inputs(cost, quality, loads)
        dev = cost.device
        plan, n = self._rows(cost.shape[0], local)
        if self._blocked(plan, n_valid, n):
            # repair/polish run shard-locally against an exact capacity
            # partition (budget mode polishes to the budget itself)
            pt = threshold if polish_threshold is None else polish_threshold
            x, info, _, _ = self._blocked_call(
                cost, quality, threshold, loads, state, n_valid, pt, plan, n,
                polish=True, stats=stats)
            return x, info
        t0 = time.perf_counter()
        x, info = self.solve(cost, quality, threshold, loads, state=state)
        if stats is not None:
            _sync(dev)
            t1 = time.perf_counter()
            stats["solve_s"] = stats.get("solve_s", 0.0) + t1 - t0
        lam1 = info.lam if self.mode == "quality" else 0.0
        x = repair_workload(x, cost, quality, loads, lam1=lam1, stats=stats)
        if self.mode == "quality":
            pt = threshold if polish_threshold is None else polish_threshold
            x = primal_polish(x, cost, quality, pt, loads, stats=stats)
        else:
            x = budget_polish(x, cost, quality, threshold, loads, stats=stats)
        if stats is not None:
            _sync(dev)
            stats["polish_s"] = (stats.get("polish_s", 0.0)
                                 + time.perf_counter() - t1)
        return x, info

    def route_window(self, cost, quality, threshold, loads,
                     state: Optional[DualState] = None, *, share=1.0,
                     polish_margin: float = 0.0, n_valid=None,
                     quality_std=None, stats: Optional[dict] = None,
                     local: bool = False
                     ) -> Tuple[torch.Tensor, SolveInfo, DualState]:
        """One streaming window: fold the cumulative ledger into this
        window's effective threshold, warm-start the ascent from the
        carried multipliers, repair/polish, and return the updated state.
        ``threshold`` is the global constraint (stream budget B, or α);
        ``share`` is the window's fraction of the remaining horizon (budget
        mode only).  ``n_valid`` marks the valid-row prefix of a padded
        window: padding rows never touch the ledger (their cost/quality are
        zeroed and masked from every sum).

        With ``robust=True`` the solve runs against the lower-confidence
        bound ``q - kappa*sigma`` (``quality_std`` when given, else the
        Bernoulli std of the clipped predicted quality), taken in float32
        on the solve's device before the path is chosen, so the fused, the
        blocked and the padded solves and the ledger all see the bound.

        ``local`` (a query mesh only): cost/quality (and ``quality_std``)
        are this rank's rows; x is still the whole window."""
        cost, quality, loads = self._inputs(cost, quality, loads)
        dev = cost.device
        if self.robust:
            if quality_std is None:
                qc = torch.clamp(quality, 0.0, 1.0)
                sigma = torch.sqrt(qc * (1.0 - qc))
            else:
                sigma = torch.as_tensor(quality_std, dtype=torch.float32,
                                        device=dev)
            kappa = torch.full((), self.kappa, dtype=torch.float32,
                               device=dev)
            quality = quality - kappa * sigma
        plan, n = self._rows(cost.shape[0], local)
        m = cost.shape[1]
        if state is None:
            state = init_dual_state(m, dev)
        threshold = _f32(threshold, dev)
        nv = n if n_valid is None else n_valid
        t_eff = fold_threshold(self.mode, threshold, state, nv, share)
        if self.mode == "quality":
            p_eff = torch.clamp(t_eff + polish_margin, 0.0, 1.0)
        else:
            p_eff = t_eff
        if self._blocked(plan, n_valid, n):
            x, info, csum, qsum = self._blocked_call(
                cost, quality, t_eff, loads, state, n_valid, p_eff, plan, n,
                polish=True, stats=stats)
        else:
            x, info = self.route_arrays(cost, quality, t_eff, loads,
                                        polish_threshold=p_eff, state=state,
                                        stats=stats)
            # the ledger books the FINAL (repaired + polished) assignment
            csum = _chosen_sum(cost, x)
            qsum = _chosen_sum(quality, x)
        deficit = (threshold * _f32(nv, dev) - qsum if self.mode == "quality"
                   else torch.zeros((), device=dev))
        new_state = DualState(
            lam=info.lam, lam_load=info.lam_load,
            budget_spent=state.budget_spent + csum,
            sr_deficit=state.sr_deficit + deficit,
            steps=state.steps + info.iters_run)
        if _sanitize.ENABLED:
            # opt-in sanitizer plane (repro_torch.analysis.sanitize): ledger
            # conservation and an independent NumPy feasibility certificate.
            # Every call is eager here, so every window is checked.
            if local:
                from repro_torch.launch.mesh import all_gather
                group = plan[0].group(plan[1])
                cost = all_gather(cost, group)
                quality = all_gather(quality, group)
            _sanitize.check_route_window(
                mode=self.mode, x=x, cost=cost, quality=quality,
                threshold=threshold, t_eff=t_eff, loads=loads,
                state_in=state, state_out=new_state, csum=csum, qsum=qsum,
                n_valid=nv, info=info)
        return x, info, new_state


# --- legacy entry points: thin wrappers over the one DualSolver code path ---
# (the JAX ``use_kernel`` selects nothing in the port: the device decides)

def solve_assignment(cost, quality, alpha, loads, *, iters: int = 150,
                     lr_quality: float = 4.0, lr_workload: float = 0.5):
    """Quality-constrained mode.  Returns (assignment (N,), SolveInfo)."""
    return DualSolver("quality", iters, lr_quality, lr_workload).solve(
        cost, quality, alpha, loads)


def solve_budget(cost, quality, budget, loads, *, iters: int = 150,
                 lr_budget: float = 50.0, lr_workload: float = 0.5):
    """Budget mode: max (1/N)Σ a_ij x_ij  s.t. Σ c_ij x_ij <= B, loads."""
    return DualSolver("budget", iters, lr_budget, lr_workload).solve(
        cost, quality, budget, loads)
