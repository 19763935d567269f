"""Plain versions for the Lagrangian assignment plane (paper Eq. 9-12).

- ``fused_dual_solve_ref``: plain PyTorch with the exact contract of the
  CUDA kernel ``csrc/dual_solve.cu`` (and of the TPU kernel's single-block
  layout): it takes the unified, already-normalized problem and returns the
  packed, fully finalised ``(8 + 3M,)`` vector.  It runs every iteration
  with the freeze gated by ``torch.where`` (no host sync), as the TPU kernel
  does.  It is the CPU path of ``ops.fused_dual_solve`` and the yardstick
  the kernel is held against on the card.
- ``shard_stats_ref``: one dual iteration's per-shard ``[ΣA, ΣB,
  histogram]`` of the blocked (masked) window solve — the stats path of
  the reference's ``_blocked_window_core`` — in plain PyTorch; the
  building block of ``blocked_dual_ascent_ref`` and the yardstick of
  ``csrc/shard_stats.cu``, whose summation order it repeats, so the two
  agree bit for bit.
- ``blocked_dual_ascent_ref``: the blocked window solve's whole ascent
  (``optimizer._blocked_window_core``'s loop) over ``shard_stats_ref``;
  the CPU path of ``ops.blocked_dual_ascent`` and the yardstick of
  ``csrc/dual_solve.cu``'s ``blocked_dual_ascent_launch``, whose order it
  repeats, so the two agree bit for bit.
- ``assign_step_ref``: one reduced-cost argmin step of the seed's
  per-iteration solve (scores ``c − λ1·a/n + λ2``, argmin, histogram, qsum,
  csum) in plain PyTorch; the CPU path of ``ops.assign_step`` and the
  yardstick of ``csrc/shard_stats.cu``'s ``assign_step_launch``, whose
  arithmetic and summation order it repeats, so the two agree bit for bit.
- ``repair_workload_ref`` / ``primal_polish_ref`` / ``budget_polish_ref``:
  NumPy oracles, copied from the JAX package, for the device repair/polish
  loops in ``repro_torch.core.optimizer``.  They follow the same
  move-selection rules (first-index tie-breaks in float32), so parity tests
  assert exact agreement.
"""
from __future__ import annotations

import numpy as np
import torch


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device (PyTorch's CPU
    float32 ``sqrt`` is not; the float64 root rounds correctly to float32)."""
    return torch.sqrt(x.double()).float()


def fused_dual_solve_ref(a_mat, b_mat, thresh, lr_eff, lr_load, lam0, lam20,
                         stall_tol, step0, loads, *, iters: int,
                         patience: int):
    """Whole dual ascent on the unified problem ``scores = A + lam*B + lam2``
    (feasible iff sum B[i, x_i] <= thresh and every count <= its load).

    Scalars are 0-dim float32 tensors (or numbers); ``lam20`` and ``loads``
    are (M,).  Returns the packed (8 + 3M,) float32 vector
    ``[lam, lam_best, best, found, 0, 0, iters_run, 0, lam2 (M),
    lam2_best (M), 0 (M)]``."""
    dev = a_mat.device
    n, m = a_mat.shape

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    thresh, lr_eff, lr_load, lam, stall_tol, step0 = (
        f32(v).reshape(()) for v in (thresh, lr_eff, lr_load, lam0,
                                     stall_tol, step0))
    loads = f32(loads).reshape(m)
    lam2 = f32(lam20).reshape(m)
    one = f32(1.0)
    lam_best, lam2_best = f32(0.0), torch.zeros_like(lam2)
    best = f32(float("inf"))
    found = torch.zeros((), dtype=torch.bool, device=dev)
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    t_run = torch.zeros((), dtype=torch.int32, device=dev)
    for t in range(iters):
        active = stall < patience
        x = torch.argmin(a_mat + lam * b_mat + lam2[None, :], dim=1)
        asum = a_mat.gather(1, x[:, None]).sum()
        bsum = b_mat.gather(1, x[:, None]).sum()
        cnt = torch.bincount(x, minlength=m).float()
        feasible = active & (bsum <= thresh) & torch.all(cnt <= loads)
        better = feasible & (asum < best)
        best = torch.where(better, asum, best)
        lam_best = torch.where(better, lam, lam_best)
        lam2_best = torch.where(better, lam2, lam2_best)
        found = found | feasible
        step = one / sqrt32(one + step0 + t)
        lam_new = torch.clamp(lam + lr_eff * step * (bsum - thresh), min=0.0)
        lam2_new = torch.clamp(lam2 + lr_load * step * (cnt - loads), min=0.0)
        delta = (lam_new - lam).abs() + (lam2_new - lam2).abs().sum()
        denom = one + lam_new.abs() + lam2_new.abs().sum()
        resid = (bsum - thresh).abs() / (one + thresh.abs())
        stalled = found & ((delta < stall_tol * denom) | (resid < stall_tol))
        stall = stall + (active & stalled).int()
        lam = torch.where(active, lam_new, lam)
        lam2 = torch.where(active, lam2_new, lam2)
        t_run = t_run + active.int()
    zero = f32(0.0)
    return torch.cat([
        torch.stack([lam, lam_best, best, found.float(), zero, zero,
                     t_run.float(), zero]),
        lam2, lam2_best, torch.zeros_like(lam2)])


STATS_ROWS = 256    # rows per block of csrc/shard_stats.cu
STATS_WARPS = 8     # its warps per block


def _kernel_order_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum the per-row values ``v`` (lblocks, nl) of each shard in the
    order of ``csrc/shard_stats.cu``: 256-row blocks; in each, a
    shuffle-down tree over each warp's 32 rows, then the 8 warp sums in
    order; then the blocks in order.  Every add is a float32 add, so the
    plain version gives the kernel's bits.  Returns (lblocks,)."""
    lb, nl = v.shape
    bps = -(-nl // STATS_ROWS)
    v = torch.nn.functional.pad(v, (0, bps * STATS_ROWS - nl))
    v = v.reshape(lb, bps, STATS_WARPS, 32)
    for o in (16, 8, 4, 2, 1):          # lane i takes lane i + o's value
        v = v[..., :o] + v[..., o:2 * o]
    v = v[..., 0]                                        # (lb, bps, warps)
    blk = torch.zeros((lb, bps), dtype=v.dtype, device=v.device)
    for w in range(STATS_WARPS):
        blk = blk + v[..., w]
    out = torch.zeros(lb, dtype=v.dtype, device=v.device)
    for b in range(bps):
        out = out + blk[:, b]
    return out


def ordered_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed order on every device: a
    pairwise tree of elementwise float32 adds (zero padding to a power of
    two).  ``Tensor.sum`` reduces in an order of its own on each device;
    the masked window solve takes every float sum this way, so the card
    and the CPU walk the same trajectory bit for bit."""
    n = v.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        v = torch.nn.functional.pad(v, (0, width - n))
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def in_shard_order(part: torch.Tensor) -> torch.Tensor:
    """Sum per-shard partials (lblocks, ...) in shard order (the
    reference's ordered cross-shard combine)."""
    total = part[0]
    for s in range(1, part.shape[0]):
        total = total + part[s]
    return total


def shard_stats_ref(a_mat, b_mat, lam, lam2, nv, *, lblocks: int):
    """Per-shard [ΣA, ΣB, histogram] for one dual iteration.

    a_mat/b_mat (lblocks·nl, M): ``lblocks`` contiguous query shards; nv
    (lblocks,) per-shard valid-row counts (rows at or past them are padding
    and add nothing).  Each row takes the argmin of ``A + lam·B + lam2``
    (lowest index on ties); the sums are taken in the CUDA kernel's order
    (:func:`_kernel_order_sum`).  Returns (lblocks, 2 + M) float32."""
    nloc, m = a_mat.shape
    nl = nloc // lblocks
    a3 = a_mat.reshape(lblocks, nl, m)
    b3 = b_mat.reshape(lblocks, nl, m)
    x = torch.argmin(a3 + lam * b3 + lam2.reshape(1, 1, m), dim=2)
    rows = torch.arange(nl, device=a_mat.device)
    valid = rows[None, :] < torch.as_tensor(nv, device=a_mat.device).reshape(
        lblocks, 1).long()
    zero = torch.zeros((), dtype=a_mat.dtype, device=a_mat.device)
    va = torch.where(valid, a3.gather(2, x[..., None])[..., 0], zero)
    vb = torch.where(valid, b3.gather(2, x[..., None])[..., 0], zero)
    hist = ((x[..., None] == torch.arange(m, device=a_mat.device))
            & valid[..., None]).sum(dim=1).float()
    return torch.cat([_kernel_order_sum(va)[:, None],
                      _kernel_order_sum(vb)[:, None], hist], dim=1)


def _same(part):
    return part


SYNC_EVERY = 8   # blocked iterations between host reads of the loop's
#                  active flag (frozen iterations change nothing)


def loop_iterations(iters: int, iters_run: int) -> int:
    """The iterations :func:`blocked_dual_ascent_ref`'s loop runs for an
    ``iters_run``: whole chunks of ``SYNC_EVERY`` up to the stall exit
    (the frozen ones past it included), at most ``iters``."""
    return min(iters, SYNC_EVERY * -(-iters_run // SYNC_EVERY))


def blocked_dual_ascent_ref(a_mat, b_mat, nv_loc, t_eff, lr_eff,
                            lr_load_eff, lam0, lam20, stall_tol, step0,
                            loads, *, iters: int, patience: int,
                            stats=None, gather=None):
    """The blocked window solve's dual ascent on the unified, normalised
    problem: a_mat/b_mat (S·nl, M) as S contiguous query shards, nv_loc
    (S,) valid rows per shard; scalars 0-dim float32 tensors; lam20 and
    loads (M,).  Each iteration takes [ΣA, ΣB, histogram] of each shard
    from ``stats`` (:func:`shard_stats_ref` by default) and combines the
    shards in order.

    The query-sharded solve runs this loop on each rank over its local
    shards: ``stats`` is then the dispatching ``ops.shard_stats`` (the
    kernel on the card) and ``gather`` the ordered all-gather that turns
    the local (S_loc, 2 + M) partials into every shard's, in global shard
    order; every rank then combines them alike.  Without ``gather`` the
    local shards are all the shards.

    The loop keeps the reference's semantics (stall early exit,
    ``iters_run`` exact) without reading its condition every iteration: an
    iteration past the exit is frozen (it changes nothing, as in the fused
    TPU kernel), and the host reads the loop's active flag once every
    ``SYNC_EVERY`` iterations.  Returns the packed (8 + 3M,) float32 vector
    of :func:`fused_dual_solve_ref` and the number of host reads made."""
    dev = a_mat.device
    m = a_mat.shape[1]

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    nv_loc = f32(nv_loc).reshape(-1)
    lblocks = nv_loc.shape[0]
    t_eff, lr_eff, lr_load_eff, lam, stall_tol, step0 = (
        f32(v).reshape(()) for v in (t_eff, lr_eff, lr_load_eff, lam0,
                                     stall_tol, step0))
    lam2 = f32(lam20).reshape(m)
    loads = f32(loads).reshape(m)
    one = f32(1.0)
    best_a = torch.full((), float("inf"), device=dev)
    lam_b, lam2_b = torch.zeros((), device=dev), torch.zeros(m, device=dev)
    found = torch.zeros((), dtype=torch.bool, device=dev)
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    t_run = torch.zeros((), dtype=torch.int32, device=dev)
    if stats is None:
        stats = shard_stats_ref
    if gather is None:
        gather = _same
    t = reads = 0
    while t < iters:
        for _ in range(min(SYNC_EVERY, iters - t)):
            active = stall < patience
            tot = in_shard_order(gather(stats(a_mat, b_mat, lam, lam2,
                                              nv_loc, lblocks=lblocks)))
            asum, bsum, cnt = tot[0], tot[1], tot[2:]
            feasible = active & (bsum <= t_eff) & torch.all(cnt <= loads)
            better = feasible & (asum < best_a)
            best_a = torch.where(better, asum, best_a)
            lam_b = torch.where(better, lam, lam_b)
            lam2_b = torch.where(better, lam2, lam2_b)
            found = found | feasible
            step = one / sqrt32(one + step0 + t)
            lam_new = torch.clamp(lam + lr_eff * step * (bsum - t_eff),
                                  min=0.0)
            lam2_new = torch.clamp(
                lam2 + lr_load_eff * step * (cnt - loads), min=0.0)
            delta = ((lam_new - lam).abs()
                     + ordered_sum((lam2_new - lam2).abs()))
            denom = one + lam_new.abs() + ordered_sum(lam2_new.abs())
            resid = (bsum - t_eff).abs() / (one + t_eff.abs())
            stalled = found & ((delta < stall_tol * denom)
                               | (resid < stall_tol))
            # cumulative — see optimizer._solve_ref
            stall = stall + (active & stalled).int()
            lam = torch.where(active, lam_new, lam)
            lam2 = torch.where(active, lam2_new, lam2)
            t_run = t_run + active.int()
            t += 1
        reads += 1
        if not bool(stall < patience):
            break
    zero = torch.zeros((), device=dev)
    return torch.cat([
        torch.stack([lam, lam_b, best_a, found.float(), zero, zero,
                     t_run.float(), zero]),
        lam2, lam2_b, torch.zeros_like(lam2)]), reads


def assign_step_ref(cost, quality, lam1, lam2, n):
    """One reduced-cost step: cost/quality (N, M) float32, lam1 a scalar
    (rounded to float32 first), lam2 (M,).  Scores ``(c − (λ1·a)/n) + λ2``
    in that order, each operation rounded on its own; the row argmin takes
    the lowest index on ties.  Returns (x (N,) int32, counts (M,) f32,
    qsum = Σ a[i, x_i], csum = Σ c[i, x_i]), the sums in the kernel's
    order (:func:`_kernel_order_sum`)."""
    dev = cost.device
    m = cost.shape[1]
    lam1 = torch.as_tensor(lam1, dtype=torch.float32, device=dev).reshape(())
    lam2 = torch.as_tensor(lam2, dtype=torch.float32, device=dev).reshape(m)
    # a tensor divisor: PyTorch's CUDA division by a Python number
    # multiplies by its reciprocal, where the kernel divides
    n_t = torch.as_tensor(n, dtype=torch.float32, device=dev)
    x = torch.argmin((cost - (lam1 * quality) / n_t) + lam2[None, :], dim=1)
    chosen = torch.stack([quality.gather(1, x[:, None])[:, 0],
                          cost.gather(1, x[:, None])[:, 0]])     # (2, N)
    qsum, csum = _kernel_order_sum(chosen)
    counts = torch.bincount(x, minlength=m).float()
    return x.to(torch.int32), counts, qsum, csum


def repair_workload_ref(x, cost, quality, loads, lam1=0.0):
    """Host-side oracle for ``repro_torch.core.optimizer.repair_workload``."""
    x = np.asarray(x).astype(np.int64).copy()
    cost = np.asarray(cost, np.float32)
    quality = np.asarray(quality, np.float32)
    loads = np.asarray(loads, np.float32)
    n, m = cost.shape
    reduced = (cost - np.float32(lam1) * quality / np.float32(n)).astype(
        np.float32)
    counts = np.bincount(x, minlength=m).astype(np.float32)
    for _ in range(n):
        over = counts - loads
        j = int(np.argmax(over))
        free = counts < loads
        if over[j] <= 0 or not free.any():
            break  # feasible, or pool saturated (caller queues the overflow)
        alt = np.where(free[None, :], reduced, np.float32(np.inf))
        best_alt = alt.argmin(axis=1)
        alt_min = alt[np.arange(n), best_alt]
        delta = np.where(x == j, alt_min - reduced[:, j], np.float32(np.inf))
        qi = int(np.argmin(delta))
        nj = int(best_alt[qi])
        x[qi] = nj
        counts[j] -= 1.0
        counts[nj] += 1.0
    return x


def primal_polish_ref(x, cost, quality, alpha, loads):
    """Host-side oracle for ``repro_torch.core.optimizer.primal_polish``."""
    x = np.asarray(x).astype(np.int64).copy()
    cost = np.asarray(cost, np.float32)
    quality = np.asarray(quality, np.float32)
    loads = np.asarray(loads, np.float32)
    n, m = cost.shape
    counts = np.bincount(x, minlength=m).astype(np.float32)
    qsum = np.float32(quality[np.arange(n), x].sum())

    # phase 0 — restore quality feasibility: best gain-per-dollar move first
    for _ in range(4 * n):
        if qsum >= np.float32(n) * np.float32(alpha) - 1e-9:
            break
        curq = quality[np.arange(n), x][:, None]
        curc = cost[np.arange(n), x][:, None]
        gain = quality - curq
        extra = cost - curc
        ok = (gain > 1e-12) & (counts[None, :] < loads[None, :])
        if not ok.any():
            break
        score = np.where(ok, gain / np.maximum(extra, np.float32(1e-9)),
                         np.float32(-np.inf))
        i, j = np.unravel_index(np.argmax(score), score.shape)
        qsum = np.float32(qsum + (quality[i, j] - quality[i, x[i]]))
        counts[x[i]] -= 1.0
        counts[j] += 1.0
        x[i] = j

    # phase 1 — steepest descent: apply the single largest feasible saving
    for _ in range(8 * n):
        curq = quality[np.arange(n), x][:, None]
        curc = cost[np.arange(n), x][:, None]
        slack = qsum - np.float32(n) * np.float32(alpha)
        delta = cost - curc
        dq = quality - curq
        ok = (delta < -1e-12) & (counts[None, :] < loads[None, :]) & \
            (dq >= -slack - 1e-12)
        if not ok.any():
            break
        score = np.where(ok, delta, np.float32(np.inf))
        i, j = np.unravel_index(np.argmin(score), score.shape)
        qsum = np.float32(qsum + (quality[i, j] - quality[i, x[i]]))
        counts[x[i]] -= 1.0
        counts[j] += 1.0
        x[i] = j
    return x


def budget_polish_ref(x, cost, quality, budget, loads):
    """Host-side oracle for ``repro_torch.core.optimizer.budget_polish``."""
    x = np.asarray(x).astype(np.int64).copy()
    cost = np.asarray(cost, np.float32)
    quality = np.asarray(quality, np.float32)
    loads = np.asarray(loads, np.float32)
    n, m = cost.shape
    counts = np.bincount(x, minlength=m).astype(np.float32)
    csum = np.float32(cost[np.arange(n), x].sum())
    # phase 0 — restore budget feasibility: least quality lost per $ saved
    for _ in range(4 * n):
        if csum <= np.float32(budget) + 1e-9:
            break
        curq = quality[np.arange(n), x][:, None]
        curc = cost[np.arange(n), x][:, None]
        dq = quality - curq
        dc = cost - curc
        ok = (dc < -1e-12) & (counts[None, :] < loads[None, :])
        if not ok.any():
            break
        score = np.where(ok, dq / np.maximum(-dc, np.float32(1e-9)),
                         np.float32(-np.inf))
        i, j = np.unravel_index(np.argmax(score), score.shape)
        csum = np.float32(csum + dc[i, j])
        counts[x[i]] -= 1.0
        counts[j] += 1.0
        x[i] = j
    # phase 1 — steepest quality ascent within the remaining budget
    for _ in range(8 * n):
        curq = quality[np.arange(n), x][:, None]
        curc = cost[np.arange(n), x][:, None]
        dq = quality - curq
        dc = cost - curc
        ok = (dq > 1e-12) & (counts[None, :] < loads[None, :]) & \
            (csum + dc <= np.float32(budget) + 1e-9)
        if not ok.any():
            break
        score = np.where(ok, dq, np.float32(-np.inf))
        i, j = np.unravel_index(np.argmax(score), score.shape)
        csum = np.float32(csum + dc[i, j])
        counts[x[i]] -= 1.0
        counts[j] += 1.0
        x[i] = j
    return x
