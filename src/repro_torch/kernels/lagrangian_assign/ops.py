"""Kernel-backed ECCOS dual solve: the contract of ``core.optimizer``.

``solve_fused`` maps (cost, quality, threshold) onto the unified problem
(``prepare_problem``: ``_mode_params`` and, with ``norm_grad``,
``_normalize_problem``), runs the whole ascent in ONE launch of the
hand-written kernel on a CUDA tensor — or in the plain version on a CPU
tensor — and then replays the winning argmin from the emitted multipliers
and builds ``SolveInfo`` (``finish``).  ``launches`` counts the kernel
launches made through ``fused_dual_solve``.

``blocked_dual_ascent`` is the whole ascent of the blocked, masked window
solve (``core.optimizer._blocked_window_core``): one launch of the
hand-written cluster kernel on a CUDA tensor, the plain loop on a CPU
tensor; ``blocked_launches`` counts its kernel launches.

``shard_stats`` is one iteration's per-shard [ΣA, ΣB, histogram] of that
ascent: one launch of the hand-written shard-statistics kernel on a CUDA
tensor, the plain version on a CPU tensor; ``stats_launches`` counts its
kernel launches.  The query-sharded solve runs it on every rank, every
iteration (``ref.blocked_dual_ascent_ref`` with ``stats=shard_stats``).

``assign_step`` is one step of the seed's per-iteration solve (one launch
per dual iteration, the structure ``solve_fused`` replaced): on a CUDA
tensor one launch of the hand-written kernel, whose last CTA adds the block
partials in order and resets its ticket counter (scratch kept per device
and stream, so a step captured into a CUDA graph replays clean); the plain
version on a CPU tensor; ``step_launches`` counts its kernel launches.
``solve_assignment_kernel`` is the legacy quality-mode entry point over
``solve_fused``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.optimizer import (SolveInfo, _f32, _mode_params,
                                        _normalize_problem)

from .kernel import (assign_step_cuda, blocked_dual_ascent_cuda,
                     dual_solve_cuda, shard_stats_cuda)
from .ref import (assign_step_ref, blocked_dual_ascent_ref,
                  fused_dual_solve_ref, shard_stats_ref)

launches = 0
blocked_launches = 0
stats_launches = 0
step_launches = 0


def assign_step(cost, quality, lam1, lam2):
    """One reduced-cost step, scores ``c − λ1·a/N + λ2``: returns (x (N,)
    int32, counts (M,), qsum, csum) (see ``ref.assign_step_ref``).  A CUDA
    tensor launches the kernel once or raises (M <= 16); a CPU tensor runs
    the plain version."""
    global step_launches
    if cost.is_cuda:
        out = assign_step_cuda(cost, quality, lam1, lam2)
        step_launches += 1
        return out
    if cost.device.type != "cpu":
        raise ValueError(f"no assign step for device {cost.device}")
    return assign_step_ref(cost, quality, lam1, lam2, cost.shape[0])


def blocked_dual_ascent(a_mat, b_mat, nv_loc, t_eff, lr_eff, lr_load_eff,
                        lam0, lam20, stall_tol, step0, loads, *, iters: int,
                        patience: int):
    """The blocked window solve's whole ascent over ``len(nv_loc)`` query
    shards; returns (the packed (8 + 3M,) vector, host reads made) (see
    ``ref.blocked_dual_ascent_ref``).  A CUDA tensor launches the kernel
    or raises, and reads the host 0 times; a CPU tensor runs the plain
    loop."""
    global blocked_launches
    args = (a_mat, b_mat, nv_loc, t_eff, lr_eff, lr_load_eff, lam0, lam20,
            stall_tol, step0, loads)
    if a_mat.is_cuda:
        out = blocked_dual_ascent_cuda(*args, iters=iters, patience=patience)
        blocked_launches += 1
        return out, 0
    if a_mat.device.type != "cpu":
        raise ValueError(f"no blocked dual ascent for device {a_mat.device}")
    return blocked_dual_ascent_ref(*args, iters=iters, patience=patience)


def shard_stats(a_mat, b_mat, lam, lam2, nv, *, lblocks: int):
    """Per-shard [ΣA, ΣB, histogram] of one dual iteration over
    ``lblocks`` contiguous shards: (lblocks, 2 + M) float32 (see
    ``ref.shard_stats_ref``).  A CUDA tensor launches the kernel once or
    raises; a CPU tensor runs the plain version."""
    global stats_launches
    if a_mat.is_cuda:
        out = shard_stats_cuda(a_mat, b_mat, lam, lam2, nv, lblocks=lblocks)
        stats_launches += 1
        return out
    if a_mat.device.type != "cpu":
        raise ValueError(f"no shard statistics for device {a_mat.device}")
    return shard_stats_ref(a_mat, b_mat, lam, lam2, nv, lblocks=lblocks)


def fused_dual_solve(a_mat, b_mat, thresh, lr_eff, lr_load, lam0, lam20,
                     stall_tol, step0, loads, *, iters: int, patience: int):
    """The whole dual ascent on the unified problem; returns the packed,
    finalised (8 + 3M,) vector (see ``ref.fused_dual_solve_ref``).  A CUDA
    tensor launches the kernel or raises; a CPU tensor runs the plain
    version."""
    global launches
    args = (a_mat, b_mat, thresh, lr_eff, lr_load, lam0, lam20, stall_tol,
            step0, loads)
    if a_mat.is_cuda:
        out = dual_solve_cuda(*args, iters=iters, patience=patience)
        launches += 1
        return out
    if a_mat.device.type != "cpu":
        raise ValueError(f"no dual solve for device {a_mat.device}")
    return fused_dual_solve_ref(*args, iters=iters, patience=patience)


class Problem(NamedTuple):
    """A solve mapped onto the unified parameterization."""

    a_mat: torch.Tensor
    b_mat: torch.Tensor
    thresh: torch.Tensor
    lr_eff: torch.Tensor
    lr_load: torch.Tensor
    lam0: torch.Tensor
    lam20: torch.Tensor
    stall_tol: torch.Tensor
    step0: torch.Tensor
    loads: torch.Tensor
    cost: torch.Tensor
    quality: torch.Tensor
    a_bar: torch.Tensor
    b_bar: torch.Tensor

    @property
    def args(self):
        """Positional arguments of ``fused_dual_solve`` and its versions."""
        return self[:10]


def prepare_problem(cost, quality, threshold, loads, *, mode: str = "quality",
                    lr_con: float = 4.0, lr_load: float = 0.5, lam0=0.0,
                    lam20=None, stall_tol=0.0, step0=0.0,
                    norm_grad: bool = False) -> Problem:
    dev = cost.device
    m = cost.shape[1]
    cost = cost.float()
    quality = _f32(quality, dev)
    loads = _f32(loads, dev)
    a_mat, b_mat, t_eff, lr_eff = _mode_params(
        cost, quality, _f32(threshold, dev), lr_con,
        budget_mode=(mode == "budget"))
    lr_eff = _f32(lr_eff, dev)
    lr_load_eff = _f32(lr_load, dev)
    a_bar = b_bar = _f32(1.0, dev)
    lam0 = _f32(lam0, dev).reshape(())
    lam20 = (torch.zeros(m, device=dev) if lam20 is None
             else _f32(lam20, dev).reshape(m))
    if norm_grad:
        # the SAME helper as the reference, so fused and reference warm
        # trajectories see identical inputs
        (a_mat, b_mat, t_eff, lr_eff, lr_load_eff, lam0, lam20,
         a_bar, b_bar) = _normalize_problem(
            a_mat, b_mat, t_eff, lr_con, lr_load, lam0, lam20, loads)
    return Problem(a_mat.contiguous(), b_mat.contiguous(), t_eff, lr_eff,
                   lr_load_eff, lam0, lam20, _f32(stall_tol, dev),
                   _f32(step0, dev).reshape(()), loads, cost, quality,
                   a_bar, b_bar)


def finish(out: torch.Tensor, p: Problem):
    """Replay the best-feasible (else last) assignment from the emitted
    multipliers — argmin is deterministic, so no N-sized state leaves the
    kernel — and build ``SolveInfo`` in true units."""
    n, m = p.cost.shape
    lam, lam_b, best_obj = out[0], out[1], out[2]
    found = out[3] > 0.0
    lam2, lam2b = out[8:8 + m], out[8 + m:8 + 2 * m]
    lam_sel = torch.where(found, lam_b, lam)
    lam2_sel = torch.where(found, lam2b, lam2)
    x = torch.argmin(p.a_mat + lam_sel * p.b_mat + lam2_sel[None, :], dim=1)
    onehot = torch.nn.functional.one_hot(x, m).float()
    asum_e = (p.a_mat * onehot).sum()
    info = SolveInfo(
        lam=lam * p.a_bar / p.b_bar, lam_load=lam2 * p.a_bar,
        feasible=found, cost=(p.cost * onehot).sum(),
        quality=(p.quality * onehot).sum() / _f32(n, out.device),
        counts=onehot.sum(dim=0),
        objective=torch.where(found, best_obj, asum_e) * p.a_bar,
        iters_run=out[6].to(torch.int32))
    return x, info


def solve_fused(cost, quality, threshold, loads, *, mode: str = "quality",
                iters: int = 150, lr_con: float = 4.0, lr_load: float = 0.5,
                lam0=0.0, lam20=None, stall_tol=0.0, step0=0.0,
                patience: int = 3, norm_grad: bool = False):
    """Fused dual solve.  Returns (x (N,), SolveInfo), the schema of
    ``DualSolver.solve``; ``lam0``/``lam20``/``step0`` warm-start a
    streaming window and ``stall_tol`` enables the early exit."""
    p = prepare_problem(cost, quality, threshold, loads, mode=mode,
                        lr_con=lr_con, lr_load=lr_load, lam0=lam0,
                        lam20=lam20, stall_tol=stall_tol, step0=step0,
                        norm_grad=norm_grad)
    return finish(fused_dual_solve(*p.args, iters=iters, patience=patience),
                  p)


def solve_assignment_kernel(cost, quality, alpha, loads, *, iters: int = 150,
                            lr_quality: float = 4.0,
                            lr_workload: float = 0.5):
    """Legacy quality-mode entry point: one fused dual solve
    (``solve_fused``).  The JAX ``bq`` is TPU tiling and has no
    counterpart: the device of ``cost`` (a tensor) decides the path."""
    return solve_fused(cost, quality, alpha, loads, mode="quality",
                       iters=iters, lr_con=lr_quality, lr_load=lr_workload)
