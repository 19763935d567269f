"""The port's dual solver against the JAX package.

- ``_solve_ref`` against the JAX ``_solve_ref`` in both modes, cold and
  warm across three streaming windows with the stall early exit: ``x`` and
  ``iters_run`` exact; λ/λ2 within 1e-5 relative cold (float32 sums taken
  in another order).  The warm windows run the scale-free (``norm_grad``)
  ascent, whose step takes ``ΣB − t``: the difference cancels, so the
  ~1e-7 relative difference between XLA's and PyTorch's float32 sums grows
  to ~4e-5 in λ over 32 iterations (measured).  There λ/λ2 are held to
  1e-4 relative; ``x`` and ``iters_run`` stay exact.
- ``fused_dual_solve_ref`` (the CUDA kernel's plain version and contract)
  against the JAX ``fused_dual_solve`` in interpret mode, its grid output
  finalised as the JAX ``ops.solve_fused`` does, for both layouts (bq 64
  and bq = n): found, ``iters_run`` and the replayed ``x`` exact; the
  multipliers within 1e-5 relative cold, and within 1e-3 relative for the
  warm normalized solve — the contract the JAX package holds its own fused
  kernel to against its reference (``tests/test_streaming_control.py``),
  for the cancellation described above (the TPU kernel also steps by an
  rsqrt, one ulp from the reference's 1/sqrt).
- ``repair_workload``, ``primal_polish`` and ``budget_polish`` against the
  NumPy oracles: exact ``x``, for several moves-per-host-sync chunk sizes,
  including ones that do not divide the move count.
- ``DualSolver.route_arrays`` against ``brute_force`` on tiny instances, and
  ``route_window`` against the JAX solver: exact ``x``, the ledger (budget
  spent, quality deficit, steps) within 1e-5 relative, the carried λ/λ2
  within 1e-3 relative — the JAX package's own fused-vs-reference λ
  contract, since long normalized ascents drift as described above.
- The blocked, masked window solve (``shards``, ``n_valid``) against the
  JAX ``_blocked_window_core`` (``DualSolver.route_window`` /``solve`` with
  ``n_valid``), both modes, ``shards`` 1 and 4, warm over three padded
  windows with garbage in the padding: ``x`` and ``iters_run`` exact, the
  ledger within 1e-5 relative and λ/λ2 within 1e-3 relative (the C4 drift
  above); garbage and zero padding bit-identical within the port;
  ``_shard_quotas`` exact; the masked ``repair_workload``,
  ``primal_polish`` and ``budget_polish`` exact against the JAX versions;
  ``shard_stats_ref`` against the JAX ``shard_stats`` kernel in interpret
  mode (histogram exact, sums within 1e-5 relative).
- ``blocked_dual_ascent_ref`` (the blocked ascent's plain version, the CPU
  path of ``ops.blocked_dual_ascent`` and the cluster kernel's yardstick)
  on the port's own prologue against the JAX ``_blocked_window_core``
  (``DualSolver.solve`` with ``n_valid``), both modes, ``shards`` 1 and 4,
  masked and unmasked, cold and warm: ``iters_run`` and ``found`` exact,
  λ/λ2 in true units within 1e-3 relative (the C4 drift above), and the
  port's ``DualSolver.solve`` bit for bit on it; with one shard and every
  row valid it is the fused plain version up to float32 summation order;
  the dispatch by device and what ``blocked_dual_ascent_cuda`` refuses.
- ``assign_step_ref`` (the assign-step kernel's plain version, the CPU path
  of ``ops.assign_step``) against the JAX ``assign_step_kernel`` in
  interpret mode (bq 32) and the JAX ``assign_step_ref``: ``x`` and the
  counts exact, qsum and csum within 1e-5 relative (float32 sums in
  another order); a duplicated column goes to the lower index.
- ``solve_assignment`` / ``solve_budget`` against the JAX ones (``x`` and
  ``iters_run`` exact, λ/λ2 within 1e-5 relative, cold);
  ``solve_assignment_kernel`` equals ``solve_assignment`` on the CPU;
  ``DualSolver.solve_grid`` / ``solve_batch`` elements equal ``solve``
  exactly, ``solve_grid`` against the JAX vmapped sweep (``x`` and
  ``iters_run`` exact, λ within 1e-4 relative: 200 undamped iterations of
  the C4 drift, measured 7e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import optimizer as jopt  # noqa: E402
from repro.data.qaserve import generate  # noqa: E402
from repro.kernels.lagrangian_assign.kernel import (  # noqa: E402
    assign_step_kernel, fused_dual_solve, shard_stats as jax_shard_stats)
from repro.kernels.lagrangian_assign.ref import (  # noqa: E402
    assign_step_ref as jax_assign_step_ref, budget_polish_ref,
    primal_polish_ref, repair_workload_ref)
from repro_torch.core import optimizer as popt  # noqa: E402
from repro_torch.kernels.lagrangian_assign import ops as pops  # noqa: E402
from repro_torch.kernels.lagrangian_assign.ref import (  # noqa: E402
    SYNC_EVERY, assign_step_ref, blocked_dual_ascent_ref,
    fused_dual_solve_ref, shard_stats_ref)

RTOL = 1e-5
WARM_RTOL = 1e-4     # normalized ascent: see the module docstring
FUSED_WARM_RTOL = 1e-3   # the JAX fused-vs-reference λ contract


def _qaserve(n, seed):
    ds = generate(n=n, seed=seed)
    return (ds.cost_matrix().astype(np.float32),
            ds.correct.astype(np.float32))


def _close(a, b, rtol=RTOL):
    return np.allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                       rtol=rtol, atol=1e-7)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _budget(cost):
    return float(cost.min(axis=1).sum() * 1.6)


@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_solve_ref_cold_matches_jax(mode):
    cost, qual = _qaserve(256, 1)
    loads = np.full(6, 256 / 3.0, np.float32)
    thr = 0.7 if mode == "quality" else _budget(cost)
    kw = dict(mode=mode, iters=60, lr_con=4.0 if mode == "quality" else 50.0,
              lr_load=0.5)
    xj, ij = jopt._solve_ref(jnp.asarray(cost), jnp.asarray(qual),
                             jnp.float32(thr), jnp.asarray(loads), **kw)
    xp, ip = popt._solve_ref(_t(cost), _t(qual), thr, _t(loads), **kw)
    assert np.array_equal(xp.numpy(), np.asarray(xj))
    assert int(ip.iters_run) == int(ij.iters_run) == 60
    assert _close(ip.lam, ij.lam) and _close(ip.lam_load, ij.lam_load)
    assert bool(ip.feasible) == bool(ij.feasible)
    assert _close(ip.cost, ij.cost) and _close(ip.quality, ij.quality)
    assert np.array_equal(ip.counts.numpy(), np.asarray(ij.counts))
    assert _close(ip.objective, ij.objective)


@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_solve_ref_warm_windows_match_jax(mode):
    """Three windows, each warm-started from its predecessor (λ, λ2, steps)
    with the stall early exit — each package carries its own state."""
    cost, qual = _qaserve(3 * 128, 2)
    loads = np.full(6, 60.0, np.float32)
    kw = dict(mode=mode, iters=150, lr_con=3.0, lr_load=0.5, patience=3,
              norm_grad=True)
    js = ps = None
    early = 0
    for w in range(3):
        c, q = cost[w * 128:(w + 1) * 128], qual[w * 128:(w + 1) * 128]
        thr = 0.7 if mode == "quality" else _budget(c)
        if js is None:
            jw, pw = (0.0, None, 0.0), (0.0, None, 0.0)
        else:
            jw = (js.lam, js.lam_load, jnp.minimum(steps_j, 400.0))
            pw = (ps.lam, ps.lam_load, torch.clamp(steps_p, max=400.0))
        xj, js = jopt._solve_ref(jnp.asarray(c), jnp.asarray(q),
                                 jnp.float32(thr), jnp.asarray(loads),
                                 jw[0], jw[1], 1e-2, jw[2], **kw)
        xp, ps = popt._solve_ref(_t(c), _t(q), thr, _t(loads), pw[0], pw[1],
                                 1e-2, pw[2], **kw)
        assert np.array_equal(xp.numpy(), np.asarray(xj)), w
        assert int(ps.iters_run) == int(js.iters_run), w
        assert _close(ps.lam, js.lam, WARM_RTOL), w
        assert _close(ps.lam_load, js.lam_load, WARM_RTOL), w
        steps_j = (0.0 if w == 0 else steps_j) + js.iters_run
        steps_p = (torch.zeros(()) if w == 0 else steps_p) + ps.iters_run
        early += int(ps.iters_run) < 150
    assert early >= 1                  # the stall exit fired


def _finalize_grid(out, thresh, loads, lr_eff, lr_load, step0, iters,
                   patience, m):
    """The JAX ``ops.solve_fused`` finalize of the grid layout, in NumPy
    float32: the last iteration's bookkeeping and dual update."""
    f = np.float32
    out = np.asarray(out, np.float32).copy()
    lam, lam_b, best, found, asum, bsum = out[:6]
    lam2, lam2b, cnt = out[8:8 + m], out[8 + m:8 + 2 * m], out[8 + 2 * m:]
    active = out[7] < patience
    feasible = active and bsum <= thresh and np.all(cnt <= loads)
    if feasible and asum < best:
        lam_b, lam2b, best = lam, lam2.copy(), asum
    found = f(found > 0 or feasible)
    if active:
        step = f(1.0) / np.sqrt(f(step0) + f(iters))
        lam = max(f(lam + f(lr_eff) * step * (bsum - thresh)), f(0.0))
        lam2 = np.maximum(lam2 + f(lr_load) * step * (cnt - loads), f(0.0))
    t_run = out[6] + f(active)
    return np.concatenate([[lam, lam_b, best, found, 0, 0, t_run, 0], lam2,
                           lam2b, np.zeros(m)]).astype(np.float32)


@pytest.mark.parametrize("case", ["quality", "budget", "warm"])
@pytest.mark.parametrize("bq", [64, 128])
def test_fused_ref_packed_matches_jax_kernel(case, bq):
    n, m, iters = 128, 6, 40
    cost, qual = _qaserve(n, 3)
    loads = np.full(m, 64.0, np.float32)
    mode = "budget" if case == "budget" else "quality"
    kw = dict(mode=mode, lr_con=50.0 if mode == "budget" else 4.0,
              lr_load=0.5)
    thr = _budget(cost) if mode == "budget" else 0.6
    if case == "warm":                 # warm start from a converged solve
        _, cold = popt._solve_ref(_t(cost), _t(qual), thr, _t(loads),
                                  stall_tol=1e-2, mode=mode, iters=150,
                                  lr_con=3.0, lr_load=0.5, norm_grad=True)
        kw.update(lr_con=3.0, norm_grad=True, stall_tol=1e-2, lam0=cold.lam,
                  lam20=cold.lam_load, step0=cold.iters_run.float())
    p = pops.prepare_problem(_t(cost), _t(qual), thr, _t(loads), **kw)
    npy = [np.asarray(v.numpy()) for v in p.args]
    a, b, t, lr_eff, lr_load, lam0, lam20, stall_tol, step0, ld = npy
    out_j, nb = fused_dual_solve(a, b, t, ld, iters=iters, lr_eff=lr_eff,
                                 lr_load=lr_load, bq=bq, lam0=lam0,
                                 lam20=lam20, stall_tol=stall_tol,
                                 step0=step0, patience=3, interpret=True)
    assert nb == (1 if bq == n else 2)
    out_j = np.asarray(out_j)
    if nb > 1:
        out_j = _finalize_grid(out_j, t, ld, lr_eff, lr_load, step0, iters,
                               3, m)
    out_p = fused_dual_solve_ref(*p.args, iters=iters, patience=3).numpy()
    assert out_p[3] == out_j[3] and out_p[6] == out_j[6]    # found, iters
    rtol = FUSED_WARM_RTOL if case == "warm" else RTOL
    for lo, hi in ((0, 3), (8, 8 + 2 * m)):                # λ, λ*, best; λ2s
        assert _close(out_p[lo:hi], out_j[lo:hi], rtol), (lo, out_p, out_j)
    xp, ip = pops.finish(torch.from_numpy(out_p), p)
    xj, _ = pops.finish(torch.from_numpy(out_j), p)
    assert np.array_equal(xp.numpy(), xj.numpy())
    if case == "warm":
        assert int(ip.iters_run) < iters            # stall exit inside


@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_solver_fused_path_matches_solve_ref(mode):
    """On the CPU the fused contract (plain version + replay) and the
    reference ascent give the same solve."""
    cost, qual = _qaserve(200, 4)
    loads = np.full(6, 70.0, np.float32)
    thr = 0.65 if mode == "quality" else _budget(cost)
    kw = dict(mode=mode, iters=80, lr_con=3.0, lr_load=0.5, patience=3,
              norm_grad=True)
    x1, i1 = pops.solve_fused(_t(cost), _t(qual), thr, _t(loads),
                              stall_tol=1e-2, **kw)
    x2, i2 = popt._solve_ref(_t(cost), _t(qual), thr, _t(loads),
                             stall_tol=1e-2, **kw)
    assert torch.equal(x1, x2)
    assert int(i1.iters_run) == int(i2.iters_run)
    assert _close(i1.lam, i2.lam) and _close(i1.cost, i2.cost)


def _moves(fn, *args, **kw):
    stats = {}
    x = fn(*args, stats=stats, **kw).numpy()
    return x, sum(v for k, v in stats.items() if k.endswith("moves"))


def _instance(seed, n=40, m=5):
    rng = np.random.RandomState(seed)
    return (rng, rng.rand(n, m).astype(np.float32),
            rng.rand(n, m).astype(np.float32))


@pytest.mark.parametrize("chunk", [1, 7, 32])
@pytest.mark.parametrize("seed", range(4))
def test_repair_workload_matches_oracle(seed, chunk):
    rng, c, a = _instance(seed)
    loads = np.full(5, 9.0, np.float32)    # tight: 45 slots for 40 queries
    x0 = rng.randint(0, 5, 40)
    lam1 = float(rng.rand() * 2)
    x, moves = _moves(popt.repair_workload, torch.from_numpy(x0), _t(c),
                      _t(a), _t(loads), lam1, chunk=chunk)
    assert np.array_equal(x, repair_workload_ref(x0, c, a, loads, lam1=lam1))
    assert np.all(np.bincount(x, minlength=5) <= loads)
    assert moves > 0


@pytest.mark.parametrize("chunk", [1, 5, 32])
@pytest.mark.parametrize("seed", range(3))
def test_polish_matches_oracle_both_modes(seed, chunk):
    rng, c, a = _instance(seed, n=60, m=5)
    loads = np.full(5, 16.0, np.float32)
    x0 = repair_workload_ref(rng.randint(0, 5, 60), c, a, loads)
    xq, _ = _moves(popt.primal_polish, torch.from_numpy(x0), _t(c), _t(a),
                   0.6, _t(loads), chunk=chunk)
    assert np.array_equal(xq, primal_polish_ref(x0, c, a, 0.6, loads))
    xb, _ = _moves(popt.budget_polish, torch.from_numpy(x0), _t(c), _t(a),
                   25.0, _t(loads), chunk=chunk)
    assert np.array_equal(xb, budget_polish_ref(x0, c, a, 25.0, loads))
    for x in (xq, xb):
        assert np.all(np.bincount(x, minlength=5) <= loads)


@pytest.mark.parametrize("kind", ["repair", "primal", "budget"])
def test_chunk_not_dividing_the_move_count(kind):
    """Chunks that do not divide the move count still stop on the same
    move as the oracle (the masked steps after `done` change nothing)."""
    rng, c, a = _instance(11, n=80, m=6)
    if kind == "budget":                   # start over budget: phase 0 works
        c = c + 0.1
        x0 = c.argmax(axis=1)
        loads = np.full(6, 80.0, np.float32)
        fn, args = popt.budget_polish, (float(1.2 * c.min(1).sum()),)
        want = budget_polish_ref(x0, c, a, args[0], loads)
    elif kind == "primal":
        loads = np.full(6, 20.0, np.float32)
        x0 = repair_workload_ref(rng.randint(0, 6, 80), c, a, loads)
        fn, args = popt.primal_polish, (0.75,)
        want = primal_polish_ref(x0, c, a, 0.75, loads)
    else:
        loads = np.full(6, 14.0, np.float32)
        x0 = np.zeros(80, np.int64)        # everything on model 0
        fn, args = popt.repair_workload, ()
        want = repair_workload_ref(x0, c, a, loads)

    def run(chunk):
        if kind == "repair":
            return _moves(fn, torch.from_numpy(x0), _t(c), _t(a), _t(loads),
                          chunk=chunk)
        return _moves(fn, torch.from_numpy(x0), _t(c), _t(a), args[0],
                      _t(loads), chunk=chunk)

    x1, moves = run(1)
    assert np.array_equal(x1, want) and moves >= 3
    chunk = next(ch for ch in range(3, moves + 2) if moves % ch)
    x2, moves2 = run(chunk)
    assert moves % chunk and moves2 == moves
    assert np.array_equal(x2, want)


def _rand_instance(seed, n=6, m=3):
    rng = np.random.RandomState(seed)
    return rng.rand(n, m).astype(np.float32), rng.rand(n, m).astype(np.float32)


@pytest.mark.parametrize("seed", range(8))
def test_quality_route_matches_brute_force(seed):
    c, a = _rand_instance(seed)
    n, m = c.shape
    loads = np.full(m, 3.0)
    xb = popt.brute_force(c, a, 0.45, loads, mode="quality")
    assert np.array_equal(
        xb if xb is None else xb,
        jopt.brute_force(c, a, 0.45, loads, mode="quality"))
    if xb is None:
        return
    x, _ = popt.DualSolver(iters=400, device="cpu").route_arrays(
        c, a, 0.45, loads)
    x = x.numpy()
    assert a[np.arange(n), x].mean() >= 0.45 - 1e-6
    assert np.all(np.bincount(x, minlength=m) <= loads)
    gap = c[np.arange(n), x].sum() - c[np.arange(n), xb].sum()
    assert gap <= 0.20 * max(c[np.arange(n), xb].sum(), 1e-6) + 1e-6


@pytest.mark.parametrize("seed", range(8))
def test_budget_route_matches_brute_force(seed):
    c, a = _rand_instance(seed)
    n, m = c.shape
    loads = np.full(m, 3.0)
    xb = popt.brute_force(c, a, 3.0, loads, mode="budget")
    if xb is None:
        return
    x, _ = popt.DualSolver(mode="budget", iters=400, lr_constraint=50.0,
                           device="cpu").route_arrays(c, a, 3.0, loads)
    x = x.numpy()
    assert c[np.arange(n), x].sum() <= 3.0 + 1e-5
    assert np.all(np.bincount(x, minlength=m) <= loads)
    gap = a[np.arange(n), xb].mean() - a[np.arange(n), x].mean()
    assert gap <= 0.10 + 1e-6


@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_route_arrays_and_window_ledger_match_jax(mode):
    cost, qual = _qaserve(3 * 96, 6)
    loads = np.full(6, 30.0, np.float32)
    kw = dict(mode=mode, iters=120, lr_constraint=3.0, stall_tol=1e-2,
              norm_grad=True)
    jsolver = jopt.DualSolver(**kw)
    psolver = popt.DualSolver(**kw, device="cpu")
    thr = 0.65 if mode == "quality" else _budget(cost)
    xj, _ = jsolver.route_arrays(cost, qual, thr, loads)
    xp, _ = psolver.route_arrays(cost, qual, thr, loads)
    assert np.array_equal(xp.numpy(), np.asarray(xj))
    js = ps = None
    for w in range(3):
        c, q = cost[w * 96:(w + 1) * 96], qual[w * 96:(w + 1) * 96]
        xj, _, js = jsolver.route_window(c, q, thr, loads, js,
                                         share=1.0 / (3 - w),
                                         polish_margin=0.03)
        xp, _, ps = psolver.route_window(c, q, thr, loads, ps,
                                         share=1.0 / (3 - w),
                                         polish_margin=0.03)
        assert np.array_equal(xp.numpy(), np.asarray(xj)), w
        for field in ("budget_spent", "sr_deficit", "steps"):
            assert _close(getattr(ps, field), getattr(js, field)), field
        assert _close(ps.lam, js.lam, 1e-3)
        assert _close(ps.lam_load, js.lam_load, 1e-3)


def test_inputs_go_to_the_solver_device():
    """NumPy inputs go to the solver's device (CUDA unless named); tensors
    keep their own."""
    c, a = _rand_instance(0)
    assert popt.default_device(popt.DualSolver().device).type == "cuda"
    got = popt.DualSolver(device="cpu")._inputs(c, a, np.full(3, 3.0))
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in got)
    got = popt.DualSolver()._inputs(torch.from_numpy(c), a, np.full(3, 3.0))
    assert all(t.device.type == "cpu" for t in got)


def test_bad_shard_configs_raise():
    """What the blocked path still refuses, as the reference does: a shard
    count below 1, and a window that does not divide into its shards."""
    with pytest.raises(ValueError, match="shards"):
        popt.DualSolver(shards=0)
    c, a = _rand_instance(0, n=10)
    with pytest.raises(ValueError, match="divide"):
        popt.DualSolver(shards=4, device="cpu").solve(c, a, 0.5,
                                                      np.full(3, 5.0))


def _padded_instance(n_pad, nv, m=5, seed=0, garbage=True):
    """A window of ``nv`` valid rows padded to ``n_pad``: garbage (or zero)
    in the padding, which the blocked solve must ignore."""
    rng = np.random.default_rng(seed)
    cost = np.zeros((n_pad, m), np.float32)
    qual = np.zeros((n_pad, m), np.float32)
    cost[:nv] = rng.uniform(0.2, 3.0, (nv, m)) * 1e-3
    qual[:nv] = rng.uniform(0.0, 1.0, (nv, m))
    if garbage:
        cost[nv:] = rng.uniform(10, 20, (n_pad - nv, m))
        qual[nv:] = rng.uniform(0, 1, (n_pad - nv, m))
    return cost, qual


WINDOWS = ((128, 100), (128, 128), (128, 77))     # (padded, valid) rows


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_blocked_window_matches_jax(mode, shards):
    kw = dict(mode=mode, iters=60, lr_constraint=3.0, stall_tol=1e-2,
              norm_grad=True, shards=shards)
    jsolver, psolver = jopt.DualSolver(**kw), popt.DualSolver(**kw,
                                                              device="cpu")
    loads = np.full(5, 30.0, np.float32)
    thr = 0.55 if mode == "quality" else 0.2
    js = ps = None
    for w, (n_pad, nv) in enumerate(WINDOWS):
        c, q = _padded_instance(n_pad, nv, seed=w)
        xj, ij, js = jsolver.route_window(c, q, thr, loads, js,
                                          share=1.0 / (3 - w),
                                          polish_margin=0.03, n_valid=nv)
        xp, ip, ps = psolver.route_window(c, q, thr, loads, ps,
                                          share=1.0 / (3 - w),
                                          polish_margin=0.03, n_valid=nv)
        assert np.array_equal(xp.numpy(), np.asarray(xj)), w
        assert int(ip.iters_run) == int(ij.iters_run), w
        assert float(ip.counts.sum()) == nv
        for field in ("budget_spent", "sr_deficit", "steps"):
            assert _close(getattr(ps, field), getattr(js, field)), field
        assert _close(ps.lam, js.lam, FUSED_WARM_RTOL)
        assert _close(ps.lam_load, js.lam_load, FUSED_WARM_RTOL)
    # the solve alone (no polish) through the same blocked core
    c, q = _padded_instance(128, 90, seed=5)
    xj, ij = jsolver.solve(c, q, thr, loads, n_valid=90)
    xp, ip = psolver.solve(c, q, thr, loads, n_valid=90)
    assert np.array_equal(xp.numpy(), np.asarray(xj))
    assert int(ip.iters_run) == int(ij.iters_run)
    assert bool(ip.feasible) == bool(ij.feasible)


@pytest.mark.parametrize("shards", [1, 4])
def test_blocked_pad_content_cannot_leak(shards):
    """Garbage and zero padding give bit-identical assignments, SolveInfo
    and stream state: the padding is zeroed and masked out of every sum."""
    s = popt.DualSolver(mode="quality", iters=40, lr_constraint=4.0,
                        norm_grad=True, shards=shards, device="cpu")
    loads = np.full(5, 17.0, np.float32)
    outs = []
    for garbage in (False, True):
        c, q = _padded_instance(96, 64, garbage=garbage)
        outs.append(s.route_window(c, q, 0.55, loads,
                                   popt.init_dual_state(5, "cpu"),
                                   n_valid=64))
    (xa, ia, sa), (xb, ib, sb) = outs
    assert torch.equal(xa[:64], xb[:64])
    for a, b in zip(list(ia) + list(sa), list(ib) + list(sb)):
        assert torch.equal(a, b)
    assert float(ia.counts.sum()) == 64
    cnt = np.bincount(xa[:64].numpy(), minlength=5)
    assert np.all(cnt <= loads)


def test_shard_quotas_match_jax():
    loads = np.array([7.0, 30.0, 1.0, np.inf, 12.0], np.float32)
    for g in (1, 3, 4, 8):
        ids = np.arange(g)
        want = np.asarray(jopt._shard_quotas(jnp.asarray(loads),
                                             jnp.asarray(ids), g))
        got = popt._shard_quotas(torch.from_numpy(loads),
                                 torch.from_numpy(ids), g).numpy()
        assert np.array_equal(got, want), g
        fin = np.isfinite(loads)
        assert np.array_equal(got[:, fin].sum(0), np.floor(loads[fin]))


@pytest.mark.parametrize("kind", ["repair", "primal", "budget"])
def test_masked_repair_and_polish_match_jax(kind):
    c, q = _padded_instance(48, 35, m=4, seed=3)
    loads = np.array([6.0, 14.0, 10.0, 12.0], np.float32)
    x0 = np.random.RandomState(2).randint(0, 4, 48).astype(np.int32)
    x0[:20] = 0                          # overload model 0
    if kind == "repair":
        want = jopt.repair_workload(x0, c, q, loads, 0.3, 35.0)
        got = popt.repair_workload(torch.from_numpy(x0), _t(c), _t(q),
                                   _t(loads), 0.3, 35, chunk=5)
    elif kind == "primal":
        want = jopt.primal_polish(x0, c, q, 0.6, loads, 35.0)
        got = popt.primal_polish(torch.from_numpy(x0), _t(c), _t(q), 0.6,
                                 _t(loads), 35, chunk=5)
    else:
        budget = float(c[:35].min(1).sum() * 1.3)
        want = jopt.budget_polish(x0, c, q, budget, loads, 35.0)
        got = popt.budget_polish(torch.from_numpy(x0), _t(c), _t(q), budget,
                                 _t(loads), 35, chunk=5)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy()[35:], x0[35:])    # padding untouched


@pytest.mark.parametrize("lblocks", [1, 4])
def test_shard_stats_ref_matches_jax_kernel(lblocks):
    rng = np.random.default_rng(lblocks)
    n, m = 160, 7
    a = rng.uniform(0, 1, (n, m)).astype(np.float32)
    b = rng.uniform(-1, 1, (n, m)).astype(np.float32)
    lam2 = rng.uniform(0, 0.3, m).astype(np.float32)
    nl = n // lblocks
    nv = np.array([nl, nl - 7, 3, 0][:lblocks], np.float32)
    want = np.asarray(jax_shard_stats(
        jnp.asarray(a), jnp.asarray(b), jnp.float32(0.4), jnp.asarray(lam2),
        jnp.asarray(nv), lblocks=lblocks, bq=16, interpret=True))
    got = shard_stats_ref(_t(a), _t(b), torch.tensor(0.4), _t(lam2),
                          _t(nv), lblocks=lblocks).numpy()
    assert got.shape == (lblocks, 2 + m)
    assert np.array_equal(got[:, 2:], want[:, 2:])
    assert np.allclose(got[:, :2], want[:, :2], rtol=1e-5, atol=1e-6)


STALL_TOL = 2e-3


def _blocked_args(c, q, thr, loads, mode, shards, nv, state):
    """The port's blocked solve up to its ascent: ``_blocked_window``'s
    zeroed padding and unified mapping, then the core's prologue.  Returns
    (the ascent's positional arguments, a_bar, b_bar)."""
    n, m = c.shape
    nvf = torch.tensor(float(nv))
    validr = (torch.arange(n) < nvf)[:, None]
    a, b, t_eff, lr_eff = popt._mode_params(
        _t(c) * validr, _t(q) * validr, torch.tensor(thr, dtype=torch.float32),
        3.0, budget_mode=(mode == "budget"), n_eff=nvf)
    lam0, lam20, step0 = ((torch.zeros(()), torch.zeros(m), torch.zeros(()))
                          if state is None else state)
    (a, b, nv_loc, t_eff, lr_eff, lr_load_eff, lam0, lam20, a_bar,
     b_bar) = popt._blocked_prologue(
        a, b, t_eff, _t(loads), torch.as_tensor(lr_eff, dtype=torch.float32),
        torch.tensor(0.5), lam0, lam20, nvf, lblocks=shards, norm_grad=True,
        lr_con=3.0, lr_load=0.5)
    return ((a, b, nv_loc, t_eff, lr_eff, lr_load_eff, lam0, lam20,
             torch.tensor(STALL_TOL), step0, _t(loads)), a_bar, b_bar)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_blocked_dual_ascent_ref_matches_jax(mode, shards, masked, warm):
    """The blocked ascent's plain version against the JAX blocked core's
    multipliers and ``iters_run``; warm from a cold JAX solve of another
    window, as a stream would be."""
    m, nv = 5, (77 if masked else 128)
    loads = np.full(m, 30.0, np.float32)
    thr = 0.55 if mode == "quality" else 0.12 * nv / 128    # both bind
    kw = dict(mode=mode, iters=60, lr_constraint=3.0, stall_tol=STALL_TOL,
              norm_grad=True, shards=shards)
    jsolver = jopt.DualSolver(**kw)
    jstate = pstate = warm_args = None
    if warm:
        c0, q0 = _padded_instance(128, 100, m=m, seed=7)
        _, i0 = jsolver.solve(c0, q0, thr, loads, n_valid=100)
        lam, lam2 = np.float32(i0.lam), np.array(i0.lam_load, np.float32)
        steps = np.float32(i0.iters_run)
        z = jnp.zeros(())
        jstate = jopt.DualState(jnp.asarray(lam), jnp.asarray(lam2), z, z,
                                jnp.asarray(steps))
        pstate = popt.DualState(torch.tensor(lam), _t(lam2), torch.zeros(()),
                                torch.zeros(()), torch.tensor(steps))
        warm_args = (pstate.lam, pstate.lam_load,
                     torch.clamp(pstate.steps, max=400.0))
    c, q = _padded_instance(128, nv, m=m, seed=shards + 2 * masked)
    _, ij = jsolver.solve(c, q, thr, loads, jstate, n_valid=nv)
    args, a_bar, b_bar = _blocked_args(c, q, thr, loads, mode, shards, nv,
                                       warm_args)
    out, reads = blocked_dual_ascent_ref(*args, iters=60, patience=3)
    t_run = int(out[6])
    assert t_run == int(ij.iters_run)
    assert bool(out[3] > 0) == bool(ij.feasible)
    assert reads == -(-t_run // SYNC_EVERY)
    lam, lam2 = out[0] * a_bar / b_bar, out[8:8 + m] * a_bar
    assert _close(lam, ij.lam, FUSED_WARM_RTOL)
    assert _close(lam2, ij.lam_load, FUSED_WARM_RTOL)
    # the port's solve runs exactly this ascent
    _, ip = popt.DualSolver(**kw, device="cpu").solve(c, q, thr, loads,
                                                      pstate, n_valid=nv)
    assert torch.equal(ip.lam, lam) and torch.equal(ip.lam_load, lam2)
    assert int(ip.iters_run) == t_run


@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_blocked_ascent_one_shard_is_the_fused_ascent(mode):
    """One shard, every row valid: the blocked plain version walks the
    fused plain version's ascent — the one-shot and the blocked entry
    points of the cluster kernel are one loop.  Same ``iters_run``, found
    and replayed ``x``; multipliers within 1e-5 relative (the fused
    version sums with ``Tensor.sum``)."""
    c, q = _padded_instance(300, 300, m=6, seed=11)
    loads = np.full(6, 80.0, np.float32)
    thr = 0.55 if mode == "quality" else 0.25
    p = pops.prepare_problem(_t(c), _t(q), thr, _t(loads), mode=mode,
                             lr_con=3.0, stall_tol=1e-2, norm_grad=True)
    fused = fused_dual_solve_ref(*p.args, iters=80, patience=3)
    blocked, _ = blocked_dual_ascent_ref(
        p.a_mat, p.b_mat, torch.tensor([300.0]), *p.args[2:], iters=80,
        patience=3)
    assert float(blocked[6]) == float(fused[6]) and blocked[3] == fused[3]
    assert _close(blocked, fused)
    xf, _ = pops.finish(fused, p)
    xb, _ = pops.finish(blocked, p)
    assert torch.equal(xf, xb)


def test_blocked_dual_ascent_dispatch_by_device():
    from repro_torch.kernels.lagrangian_assign.kernel import (
        blocked_dual_ascent_cuda)
    rng = np.random.default_rng(3)
    a = _t(rng.uniform(0, 1, (64, 4)))
    b = _t(rng.uniform(-1, 1, (64, 4)) / 64)
    rest = (torch.tensor(-0.3), torch.tensor(2.0), torch.tensor(0.1),
            torch.tensor(0.0), torch.zeros(4), torch.tensor(1e-2),
            torch.tensor(0.0), torch.full((4,), 12.0))
    nv = _t([32.0, 9.0])
    before = pops.blocked_launches
    got, reads = pops.blocked_dual_ascent(a, b, nv, *rest, iters=30,
                                          patience=3)
    assert pops.blocked_launches == before
    want, want_reads = blocked_dual_ascent_ref(a, b, nv, *rest, iters=30,
                                               patience=3)
    assert torch.equal(got, want) and reads == want_reads >= 1
    meta = torch.zeros((64, 4), device="meta")
    with pytest.raises(ValueError):
        pops.blocked_dual_ascent(meta, meta, nv, *rest, iters=3, patience=3)
    with pytest.raises(ValueError, match="CUDA"):
        blocked_dual_ascent_cuda(a, b, nv, *rest, iters=3, patience=3)
    wide = torch.zeros((64, 17))
    with pytest.raises(ValueError, match="models"):
        blocked_dual_ascent_cuda(wide, wide, nv, *rest, iters=3, patience=3)
    for bad in (_t([1.0, 2.0, 3.0]), _t([[32.0], [9.0]]), _t([])):
        with pytest.raises(ValueError, match="nv_loc"):
            blocked_dual_ascent_cuda(a, b, bad, *rest, iters=3, patience=3)


def _step_inputs(n, m, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, m).astype(np.float32),
            rng.rand(n, m).astype(np.float32), float(rng.rand() * 3),
            rng.rand(m).astype(np.float32))


@pytest.mark.parametrize("n,m,seed", [(4, 2, 0), (17, 3, 1), (33, 8, 2),
                                      (50, 5, 3), (63, 6, 4), (80, 4, 5)])
def test_assign_step_ref_matches_jax(n, m, seed):
    c, a, lam1, lam2 = _step_inputs(n, m, seed)
    x, cnt, qs, cs = pops.assign_step(_t(c), _t(a), lam1, _t(lam2))
    assert x.dtype == torch.int32 and cnt.shape == (m,)
    for jx, jcnt, jq, jc in (
            assign_step_kernel(c, a, lam1, lam2, bq=32),
            jax_assign_step_ref(jnp.asarray(c), jnp.asarray(a), lam1,
                                jnp.asarray(lam2), n)):
        assert np.array_equal(x.numpy(), np.asarray(jx))
        assert np.array_equal(cnt.numpy(), np.asarray(jcnt))
        assert _close(qs, jq) and _close(cs, jc)
    xi = x.numpy()
    assert np.array_equal(cnt.numpy(), np.bincount(xi, minlength=m))
    assert float(qs) == pytest.approx(float(a[np.arange(n), xi].sum()),
                                      rel=1e-5)


def test_assign_step_tie_goes_to_lower_index():
    """Column 3 a copy of column 1 (cost, quality and λ2): every row that
    would take either takes 1, as jnp.argmin does."""
    c, a, lam1, lam2 = _step_inputs(70, 5, 9)
    c[:, 3], a[:, 3], lam2[3] = c[:, 1], a[:, 1], lam2[1]
    lam2[[0, 2, 4]] += 0.5             # make column 1 (= 3) win often
    x, cnt, _, _ = assign_step_ref(_t(c), _t(a), lam1, _t(lam2), 70)
    jx = np.asarray(assign_step_kernel(c, a, lam1, lam2, bq=32)[0])
    assert np.array_equal(x.numpy(), jx)
    assert int(cnt[3]) == 0 and int(cnt[1]) > 0


def test_assign_step_dispatch_by_device(monkeypatch):
    from repro_torch.kernels.lagrangian_assign import kernel as pkernel
    c, a, lam1, lam2 = _step_inputs(20, 3, 4)
    before = pops.step_launches
    got = pops.assign_step(_t(c), _t(a), lam1, _t(lam2))
    assert pops.step_launches == before
    want = assign_step_ref(_t(c), _t(a), lam1, _t(lam2), 20)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        pops.assign_step(meta, meta, 0.5, torch.zeros(3, device="meta"))

    # CPU, meta and mixed-device arguments raise before any CUDA call, on
    # the fast path's arguments (float32 contiguous tensors) and on the
    # slow path's (numbers, float64, strides)
    def no_cuda(*args, **kwargs):
        raise AssertionError("a CUDA call was made")

    monkeypatch.setattr(pkernel, "_launch_step", no_cuda)
    monkeypatch.setattr(pkernel, "_step_launcher", no_cuda)
    monkeypatch.setattr(torch.cuda, "current_device", no_cuda)

    def fast(dc, dq, dl):
        return (_t(c).to(dc), _t(a).to(dq), torch.tensor(lam1).to(dl),
                _t(lam2).to(dl))

    def slow(dc, dq, dl):
        return (torch.as_tensor(c, dtype=torch.float64).to(dc),
                _t(a).t().contiguous().t().to(dq), float(lam1),
                lam2.tolist())

    for args in (fast, slow):
        for devs in (("cpu",) * 3, ("meta",) * 3, ("meta", "cpu", "meta"),
                     ("cpu", "meta", "cpu"), ("meta", "meta", "cpu")):
            with pytest.raises(ValueError):
                pkernel.assign_step_cuda(*args(*devs))


def test_assign_step_cuda_path_choice():
    """What the wrapper's fast path takes (``_fast_ok``, device-agnostic
    so meta tensors stand for the card here) and what the slow path
    converts or refuses (``_slow_args``)."""
    from repro_torch.kernels.lagrangian_assign.kernel import (_fast_ok,
                                                              _slow_args)
    meta = torch.device("meta")

    def args(**kw):
        d = dict(cost=torch.zeros(40, 3, device=meta),
                 quality=torch.zeros(40, 3, device=meta),
                 lam1=torch.zeros((), device=meta),
                 lam2=torch.zeros(3, device=meta))
        d.update(kw)
        return d

    assert _fast_ok(**args())
    assert _fast_ok(**args(lam1=torch.zeros(1, device=meta)))
    for kw in (dict(quality=torch.zeros(40, 3)), dict(lam2=torch.zeros(3)),
               dict(lam1=torch.zeros(())), dict(lam1=0.5),
               dict(lam2=[0.0, 0.0, 0.0]),
               dict(cost=torch.zeros(40, 3, device=meta,
                                     dtype=torch.float64)),
               dict(lam2=torch.zeros(3, device=meta, dtype=torch.float64)),
               dict(cost=torch.zeros(3, 40, device=meta).t()),
               dict(lam2=torch.zeros(6, device=meta)[::2]),
               dict(quality=torch.zeros(40, 4, device=meta)),
               dict(cost=torch.zeros(40, 17, device=meta),
                    quality=torch.zeros(40, 17, device=meta),
                    lam2=torch.zeros(17, device=meta)),
               dict(cost=torch.zeros(0, 3, device=meta),
                    quality=torch.zeros(0, 3, device=meta))):
        assert not _fast_ok(**args(**kw)), kw
    c, a, l1, l2, n, m = _slow_args(meta, **args(lam1=0.5,
                                                 lam2=[0.0, 1.0, 2.0]))
    assert (n, m) == (40, 3) and c.shape == (120,) and l1.shape == (1,)
    assert all(t.device == meta and t.dtype == torch.float32
               for t in (c, a, l1, l2))
    for kw in (dict(quality=torch.zeros(40, 3)), dict(lam2=torch.zeros(3)),
               dict(lam1=torch.zeros(())), dict(lam2=[0.0, 1.0]),
               dict(quality=torch.zeros(40, 4, device=meta)),
               dict(cost=torch.zeros(40, 17, device=meta),
                    quality=torch.zeros(40, 17, device=meta),
                    lam2=torch.zeros(17, device=meta)),
               dict(cost=torch.zeros(0, 3, device=meta),
                    quality=torch.zeros(0, 3, device=meta))):
        with pytest.raises(ValueError):
            _slow_args(meta, **args(**kw))


@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_legacy_solvers_match_jax(mode):
    cost, qual = _qaserve(256, 1)
    loads = np.full(6, 256 / 3.0, np.float32)
    if mode == "quality":
        xj, ij = jopt.solve_assignment(cost, qual, 0.7, loads)
        xp, ip = popt.solve_assignment(_t(cost), _t(qual), 0.7, _t(loads))
    else:
        budget = _budget(cost)
        xj, ij = jopt.solve_budget(cost, qual, budget, loads)
        xp, ip = popt.solve_budget(_t(cost), _t(qual), budget, _t(loads))
    assert np.array_equal(xp.numpy(), np.asarray(xj))
    assert int(ip.iters_run) == int(ij.iters_run) == 150
    assert _close(ip.lam, ij.lam) and _close(ip.lam_load, ij.lam_load)
    assert bool(ip.feasible) == bool(ij.feasible)
    assert np.array_equal(ip.counts.numpy(), np.asarray(ij.counts))


def test_solve_assignment_kernel_matches_solve_assignment():
    """The legacy fused entry point and the reference ascent give the same
    solve (the JAX package's ``test_kernel_solver_matches_jnp_solver``)."""
    rng = np.random.RandomState(0)
    c, a = _t(rng.rand(200, 6)), _t(rng.rand(200, 6))
    loads = torch.full((6,), 60.0)
    x1, i1 = pops.solve_assignment_kernel(c, a, 0.6, loads, iters=80)
    x2, i2 = popt.solve_assignment(c, a, 0.6, loads, iters=80)
    assert torch.equal(x1, x2)
    assert abs(float(i1.cost) - float(i2.cost)) < 1e-3
    assert int(i1.iters_run) == int(i2.iters_run) == 80


def _info_equal(batched, k, single):
    return all(torch.equal(f[k], g) for f, g in zip(batched, single))


def test_solve_grid_matches_jax_and_solve():
    rng = np.random.RandomState(3)
    c, a = rng.rand(80, 5).astype(np.float32), rng.rand(80, 5).astype(
        np.float32)
    loads = np.full(5, 40.0, np.float32)
    alphas = np.array([0.3, 0.5, 0.7], np.float32)
    solver = popt.DualSolver(iters=200, device="cpu")
    xs, infos = solver.solve_grid(c, a, alphas, loads)
    assert xs.shape == (3, 80) and infos.lam_load.shape == (3, 5)
    for k, alpha in enumerate(alphas):
        x1, i1 = solver.solve(c, a, float(alpha), loads)
        assert torch.equal(xs[k], x1) and _info_equal(infos, k, i1)
    xj, ij = jopt.DualSolver(iters=200).solve_grid(c, a, alphas, loads)
    assert np.array_equal(xs.numpy(), np.asarray(xj))
    assert np.array_equal(infos.iters_run.numpy(), np.asarray(ij.iters_run))
    assert _close(infos.lam, ij.lam, WARM_RTOL)
    quals = [a[np.arange(80), x].mean() for x in xs.numpy()]
    assert quals[0] <= quals[1] + 1e-6 <= quals[2] + 2e-6


@pytest.mark.parametrize("per_element_loads", [False, True])
@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_solve_batch_elements_equal_solve(mode, per_element_loads):
    rng = np.random.RandomState(7)
    bsz, n, m = 3, 60, 4
    c = rng.rand(bsz, n, m).astype(np.float32)
    a = rng.rand(bsz, n, m).astype(np.float32)
    if mode == "quality":
        thr = np.array([0.5, 0.6, 0.7], np.float32)
    else:
        thr = (c.min(2).sum(1) * np.array([1.2, 1.5, 2.0])).astype(np.float32)
    loads = (rng.randint(18, 30, (bsz, m)).astype(np.float32)
             if per_element_loads else np.full(m, 20.0, np.float32))
    solver = popt.DualSolver(mode=mode, iters=120, device="cpu",
                             lr_constraint=4.0 if mode == "quality" else 50.0)
    xs, infos = solver.solve_batch(c, a, thr, loads)
    assert xs.shape == (bsz, n) and infos.iters_run.shape == (bsz,)
    for b in range(bsz):
        lb = loads[b] if per_element_loads else loads
        x1, i1 = solver.solve(c[b], a[b], float(thr[b]), lb)
        assert torch.equal(xs[b], x1) and _info_equal(infos, b, i1)
    xj, ij = jopt.DualSolver(mode=mode, iters=120, lr_constraint=(
        4.0 if mode == "quality" else 50.0)).solve_batch(c, a, thr, loads)
    assert np.array_equal(xs.numpy(), np.asarray(xj))
    assert np.array_equal(infos.iters_run.numpy(), np.asarray(ij.iters_run))
