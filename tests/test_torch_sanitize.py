"""The port's sanitizer plane (``repro_torch.analysis.sanitize``).

The port of ``tests/test_sanitize.py``: every member has a known-bad
fixture it flags and a known-good path it stays quiet on — PageSan (the
shadow allocator over the port's ``PageAllocator``/``Endpoint``),
LedgerSan (``DualState`` conservation), SolveCert (independent feasibility
certificates) and the schedule race checker (seeded event-order
permutation over the port's engine and simulator executors) — plus the
off state (no work, no counter moves) and the ``REPRO_SANITIZE`` wiring.
``tests/conftest.py``'s ``sanitize`` marker switches the reference's plane,
so these tests switch the port's with its own ``enabled()``.

Against the JAX package: one seeded stream routed by both solvers with
SolveCert and LedgerSan on gives the same certificate per window (counts,
``n_valid``, mode, feasibility and violations exact; the window sums and
threshold within 1e-5 relative; λ within 1e-3 relative, the
``route_window`` contract of ``tests/test_torch_optimizer.py``), unmasked
and masked; a ledger replaced between windows and an assignment that
breaks capacity make both packages raise.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hyp import given, settings, st  # noqa: E402

from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.analysis.sanitize import (LedgerSan,  # noqa: E402
                                           LedgerSanError, PageSan,
                                           PageSanError, SolveCertError,
                                           certify_window)

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# PageSan
# ---------------------------------------------------------------------------

_EP_CACHE = {}


def _endpoint():
    """One smoke endpoint shared by the PageSan tests (drained between
    uses — that is exactly the invariant under test)."""
    ep = _EP_CACHE.get("ep")
    if ep is None:
        from repro_torch.configs import get_smoke_config
        from repro_torch.serving.engine import Endpoint
        ep = Endpoint(get_smoke_config("h2o-danube-3-4b"), max_concurrency=3,
                      t_max=32, page_size=8, sync_every=2, seed=0,
                      device="cpu")
        _EP_CACHE["ep"] = ep
    if ep.alloc.san is None:
        PageSan.attach(ep)
    return ep


@settings(max_examples=8, deadline=None)
@given(ops=st.lists(st.integers(0, 9), min_size=1, max_size=20),
       seed=st.integers(0, 999))
def test_pagesan_endpoint_fuzz_admit_cancel_complete(ops, seed):
    """Randomized admit / cancel (the hedging straggler-kill path) /
    decode-chunk churn over a live endpoint, PageSan auditing after every
    mutation; every trace must drain back to a pristine pool."""
    from repro_torch.serving.engine import Request
    ep = _endpoint()
    rng = np.random.RandomState(seed)
    rid = 0
    with sanitize.enabled("pagesan"):
        events0 = sanitize.counters["events"]
        for op in ops:
            if op < 5 and ep.has_capacity():
                plen = int(rng.randint(1, 9))
                ep.admit(Request(rid=rid, tokens=rng.randint(
                    1, 200, (plen,)).astype(np.int32),
                    max_new=int(rng.randint(1, 5))))
                rid += 1
            elif op < 7:
                act = ep.active_requests()
                if act:
                    ep.cancel(act[int(rng.randint(len(act)))])
            else:
                ep.step()
        while ep.active_count():
            ep.step()
        ep.alloc.san.assert_drained(ep)
        assert sanitize.counters["events"] > events0
    assert len(ep.alloc.free_slots) == ep.L
    assert len(ep.alloc.free_pages) == ep.alloc.n_pages - 1


def test_pagesan_double_free_fires():
    from repro_torch.serving.engine import PageAllocator
    a = PageAllocator(n_pages=8, n_slots=2)
    san = PageSan(a)
    a.san = san
    pages = a.alloc_pages(2)
    a.release_pages(pages)
    # the allocator's own check is the first line of defense...
    with pytest.raises(RuntimeError, match="already free"):
        a.release_pages(pages)
    # ...and the shadow proves it independently
    with pytest.raises(PageSanError, match="double-free"):
        san.on_release_pages([pages[0]])
    with pytest.raises(PageSanError, match="double-free"):
        san.on_release_slot(a.free_slots[-1])


def test_pagesan_leak_fires():
    from repro_torch.serving.engine import PageAllocator
    a = PageAllocator(n_pages=6, n_slots=2)
    san = PageSan(a)
    a.san = san
    a.alloc_pages(2)                      # never released
    with pytest.raises(PageSanError, match="leaked"):
        san.assert_drained()


def test_pagesan_uaf_alias_and_dump_page_fire():
    """Seeded corruptions of a LIVE endpoint's block table: a row pointing
    at a freed page (use-after-free), two rows sharing a page (aliasing),
    and a decode write position resolving to page 0 (dump-page violation).
    Each is repaired afterwards and the endpoint drains clean."""
    from repro_torch.serving.engine import Request
    ep = _endpoint()
    rng = np.random.RandomState(0)
    with sanitize.enabled("pagesan"):
        ep.admit(Request(rid=100, tokens=rng.randint(1, 200, (9,)).astype(
            np.int32), max_new=3))
        ep.admit(Request(rid=101, tokens=rng.randint(1, 200, (9,)).astype(
            np.int32), max_new=3))
        s0 = next(s for s, r in enumerate(ep.slot_req) if r is not None)
        s1 = next(s for s, r in enumerate(ep.slot_req)
                  if r is not None and s != s0)
        san = ep.alloc.san

        # use-after-free: wire a FREE page into a live row
        keep = int(ep.block_table[s0, 0])
        ep.block_table[s0, 0] = ep.alloc.free_pages[-1]
        with pytest.raises(PageSanError, match="use-after-free|disagrees"):
            san.check_endpoint(ep)
        ep.block_table[s0, 0] = keep

        # cross-slot aliasing: the same physical page in two live page lists
        keep_pages = list(ep._slot_pages[s1])
        keep_row = ep.block_table[s1].copy()
        ep._slot_pages[s1] = [ep._slot_pages[s0][0]] + keep_pages[1:]
        ep.block_table[s1, 0] = ep._slot_pages[s0][0]
        with pytest.raises(PageSanError, match="alias"):
            san.check_endpoint(ep)
        ep._slot_pages[s1] = keep_pages
        ep.block_table[s1] = keep_row

        # dump-page violation: the slot's next write position is page 0
        wpos = int(ep.lens[s0]) // ep.page_size
        keep = int(ep.block_table[s0, wpos])
        keep_pages = list(ep._slot_pages[s0])
        ep.block_table[s0, wpos] = 0
        ep._slot_pages[s0] = keep_pages[:wpos] if wpos else []
        with pytest.raises(PageSanError, match="dump-page|disagrees|leaked"):
            san.check_endpoint(ep)
        ep.block_table[s0, wpos] = keep
        ep._slot_pages[s0] = keep_pages

        # freed-slot rows must stay zeroed (their writes land on page 0)
        act = ep.active_requests()
        ep.cancel(act[0])
        dead = next(s for s in (s0, s1) if ep.slot_req[s] is None)
        ep.block_table[dead, 0] = 3
        with pytest.raises(PageSanError, match="retains a nonzero"):
            san.check_endpoint(ep)
        ep.block_table[dead, 0] = 0

        ep.cancel(ep.active_requests()[0])
        san.assert_drained(ep)


def test_sanitizers_off_is_zero_overhead():
    """The off state does NO shadow-state work: no PageSan attach, no hook
    dispatch, no counter movement."""
    from repro_torch.serving.engine import PageAllocator
    with sanitize.disabled():
        assert not sanitize.any_active()
        before = dict(sanitize.counters)
        a = PageAllocator(n_pages=16, n_slots=4)
        assert a.san is None
        s = a.alloc_slot()
        p = a.alloc_pages(3)
        a.release_pages(p)
        a.release_slot(s)
        assert sanitize.counters == before


def test_sanitizers_off_do_no_work_over_a_serving_run_and_a_stream():
    """Off, a served pool attaches no shadow and a streamed route through
    the control loop (``OmniRouter`` behind ``run_serving``'s
    ``StreamController``) moves no counter."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import (BalanceAware, OmniRouter,
                                  RetrievalPredictor, RouterConfig,
                                  SchedulerConfig, run_serving)
    from repro_torch.data.qaserve import generate
    from repro_torch.serving.engine import (Endpoint, MultiLLMServer,
                                            Request, null_route_features)
    with sanitize.disabled():
        before = dict(sanitize.counters)
        ep = Endpoint(get_smoke_config("gemma3-4b"), max_concurrency=2,
                      t_max=32, page_size=8, sync_every=2, device="cpu")
        srv = MultiLLMServer([ep], BalanceAware(), batch_size=2)
        rng = np.random.RandomState(1)
        for rid in range(3):
            srv.submit(Request(rid, rng.randint(1, 200, (6,)).astype(
                np.int32), max_new=3))
        assert len(srv.run(null_route_features)) == 3
        assert ep.alloc.san is None
        train, _, test = generate(n=600, seed=0).split()
        router = OmniRouter(RetrievalPredictor(k=4, device="cpu").fit(train),
                            RouterConfig(alpha=0.7))
        res = run_serving(test.subset(np.arange(40)), router, SchedulerConfig(
            arrival="poisson", arrival_rate=40.0, streaming_dual=True,
            window=0.1, loads=4, seed=0))
        assert res.windows > 1
        assert sanitize.counters == before


def test_sanitize_enabled_and_disabled_compose():
    with sanitize.disabled():
        assert not sanitize.active("pagesan")
        with sanitize.enabled("pagesan"):
            assert sanitize.active("pagesan")
            assert not sanitize.active("ledgersan")
            with sanitize.enabled():    # no args = every member
                assert all(sanitize.active(m) for m in sanitize.ALL_MEMBERS)
            assert sanitize.active("pagesan")
            assert not sanitize.active("solvecert")
        assert not sanitize.any_active()
    with pytest.raises(ValueError, match="unknown sanitizer"):
        with sanitize.enabled("pagesan", "typo"):
            pass


@pytest.mark.parametrize("value,want", [("pagesan,solvecert",
                                         "['pagesan', 'solvecert']"),
                                        ("all", "['ledgersan', 'pagesan', "
                                                "'solvecert']"),
                                        ("", "[]")])
def test_sanitize_env_wiring(value, want):
    """``REPRO_SANITIZE`` is read once at import: the port's plane turns on
    exactly the named members (one switch for both packages)."""
    code = ("from repro_torch.analysis import sanitize\n"
            "print(sorted(sanitize.ENABLED))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_SANITIZE=value)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == want


def test_sanitize_env_rejects_unknown_members():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_SANITIZE="pagesan,typo")
    res = subprocess.run([sys.executable, "-c",
                          "import repro_torch.analysis.sanitize"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "unknown sanitizer" in res.stderr


# ---------------------------------------------------------------------------
# LedgerSan + SolveCert
# ---------------------------------------------------------------------------

def _window_instance(seed=0, n=24, m=4):
    rng = np.random.RandomState(seed)
    cost = rng.rand(n, m).astype(np.float32)
    qual = rng.rand(n, m).astype(np.float32)
    loads = np.full(m, 2.0 * n, np.float32)
    return cost, qual, loads


def test_ledgersan_and_solvecert_certify_eager_stream():
    """Known-good: every route_window in a budget stream carries a passing
    certificate and a conserving ledger transition."""
    from repro_torch.core.optimizer import DualSolver, init_dual_state
    cost, qual, loads = _window_instance()
    B = 0.45 * len(cost)
    with sanitize.enabled("ledgersan", "solvecert"):
        certs0 = sanitize.counters["certs"]
        checks0 = sanitize.counters["checks"]
        solver = DualSolver(mode="budget", iters=60, device="cpu")
        st_ = init_dual_state(len(loads), "cpu")
        for k in range(3):
            sl = slice(k * 8, (k + 1) * 8)
            x, info, st_ = solver.route_window(cost[sl], qual[sl], B, loads,
                                               st_, share=8 / (24 - k * 8))
        windows = 3
        assert sanitize.counters["certs"] - certs0 == windows
        assert sanitize.counters["checks"] - checks0 == windows
        for cert in list(sanitize.last_certificates)[-windows:]:
            assert cert.ok and cert.mode == "budget"
        assert float(st_.budget_spent) <= B + 1e-4


def test_ledgersan_conservation_and_overwrite_fire():
    from repro_torch.core.optimizer import init_dual_state
    st0 = init_dual_state(3, "cpu")
    good = st0._replace(budget_spent=torch.tensor(2.0),
                        steps=torch.tensor(10.0))
    # known-good transition passes
    sanitize.check_window_transition(
        mode="budget", threshold=5.0, state_in=st0, state_out=good,
        csum=2.0, qsum=0.0, n_valid=4, iters_run=10.0)
    # ledger overwrite: reported spend disagrees with the window cost sum
    with pytest.raises(LedgerSanError, match="conservation"):
        sanitize.check_window_transition(
            mode="budget", threshold=5.0, state_in=st0, state_out=good,
            csum=0.5, qsum=0.0, n_valid=4, iters_run=10.0)
    # spend above the global budget
    with pytest.raises(LedgerSanError, match="exceeds the global budget"):
        sanitize.check_window_transition(
            mode="budget", threshold=1.5, state_in=st0, state_out=good,
            csum=2.0, qsum=0.0, n_valid=4, iters_run=10.0)
    # monotonicity: a ledger that moves backwards
    with pytest.raises(LedgerSanError, match="decreased"):
        sanitize.check_state_monotone(good, st0)


def test_ledgersan_cumulative_audit_fires_on_replaced_ledger():
    from repro_torch.core.optimizer import init_dual_state
    audit = LedgerSan(mode="budget", threshold=10.0)
    st0 = init_dual_state(2, "cpu")
    st1 = st0._replace(budget_spent=torch.tensor(1.0),
                       steps=torch.tensor(5.0))
    audit.observe(st0, st1, csum=1.0, iters_run=5)
    # the ledger swapped wholesale between windows: conservation holds per
    # transition but the independent running total disagrees
    st1_tampered = st1._replace(budget_spent=torch.tensor(4.0))
    st2 = st1_tampered._replace(budget_spent=torch.tensor(5.0),
                                steps=torch.tensor(9.0))
    with pytest.raises(LedgerSanError, match="independent sum"):
        audit.observe(st1_tampered, st2, csum=1.0, iters_run=4)


def test_solvecert_flags_capacity_budget_and_slack_violations():
    cost, qual, loads = _window_instance(n=8)
    tight = np.array([1.0, 8.0, 8.0, 8.0], np.float32)
    with pytest.raises(SolveCertError, match="capacity"):
        certify_window(np.zeros(8, int), cost, qual, 100.0, tight, "budget")
    x = np.argmax(cost, axis=1)          # deliberately expensive choices
    spend = float(cost[np.arange(8), x].sum())
    with pytest.raises(SolveCertError, match="exceeds the effective budget"):
        certify_window(x, cost, qual, spend / 2, loads, "budget",
                       feasible=True)
    cert = certify_window(x, cost, qual, spend / 2, loads, "budget",
                          feasible=False, strict=True)
    assert cert.ok
    with pytest.raises(SolveCertError, match="pad rows leaked"):
        certify_window(x, cost, qual, spend * 2, loads, "budget",
                       csum=spend + 1.0)
    cheap = np.argmin(cost, axis=1)
    with pytest.raises(SolveCertError, match="complementary-slackness"):
        certify_window(cheap, cost, qual, 1000.0, loads, "budget",
                       lam=50.0, feasible=True)
    with pytest.raises(SolveCertError, match="below the α threshold"):
        certify_window(np.argmin(qual, axis=1), cost, qual, 0.99, loads,
                       "quality", feasible=True)


def test_solvecert_quality_mode_window_passes():
    from repro_torch.core.optimizer import DualSolver, init_dual_state
    cost, qual, loads = _window_instance(seed=2)
    with sanitize.enabled("ledgersan", "solvecert"):
        solver = DualSolver(mode="quality", iters=60, device="cpu")
        x, info, st_ = solver.route_window(cost, qual, 0.5, loads,
                                           init_dual_state(len(loads), "cpu"))
        cert = sanitize.last_certificates[-1]
        assert cert.ok and cert.mode == "quality"


def test_route_window_sanitizers_off_do_no_work():
    from repro_torch.core.optimizer import DualSolver, init_dual_state
    cost, qual, loads = _window_instance(seed=3)
    with sanitize.disabled():
        before = dict(sanitize.counters)
        n_certs = len(sanitize.last_certificates)
        DualSolver(mode="budget", iters=40, device="cpu").route_window(
            cost, qual, 8.0, loads, init_dual_state(len(loads), "cpu"))
        assert sanitize.counters == before
        assert len(sanitize.last_certificates) == n_certs


def test_certs_equal_windows_on_every_router_path():
    """The port has no tracing, so every window is eager: the streamed
    ``OmniRouter.route_window`` (padded, masked windows through
    ``run_serving``'s control loop) certifies every window, and LedgerSan
    checks each one at the solver and again at the router and the
    controller."""
    from repro_torch.core import (OmniRouter, RetrievalPredictor,
                                  RouterConfig, SchedulerConfig, run_serving)
    from repro_torch.data.qaserve import generate
    train, _, test = generate(n=600, seed=0).split()
    router = OmniRouter(RetrievalPredictor(k=4, device="cpu").fit(train),
                        RouterConfig(alpha=0.7))
    with sanitize.enabled("ledgersan", "solvecert"):
        c0, k0 = sanitize.counters["certs"], sanitize.counters["checks"]
        res = run_serving(test.subset(np.arange(40)), router, SchedulerConfig(
            arrival="poisson", arrival_rate=40.0, streaming_dual=True,
            window=0.1, loads=4, seed=0))
        certs = sanitize.counters["certs"] - c0
        checks = sanitize.counters["checks"] - k0
    assert res.windows > 1 and router.windows == res.windows
    assert certs == res.windows
    assert checks == 3 * res.windows - 1    # the first window has no state in
    for cert in list(sanitize.last_certificates)[-certs:]:
        assert cert.ok and cert.n_valid >= 1


# -- parity with the JAX package ---------------------------------------------

def _stream_certs(solver, init_state, windows, mode, masked):
    """Route ``windows`` through ``solver.route_window`` (the caller turns
    SolveCert and LedgerSan on in the package ``solver`` belongs to)."""
    thr = 0.6 if mode == "quality" else 20.0
    state = init_state
    for k, (c, q, loads, nv) in enumerate(windows):
        kw = dict(share=1.0 / (len(windows) - k))
        if masked:
            kw["n_valid"] = nv
        _, _, state = solver.route_window(c, q, thr, loads, state, **kw)


def _cert_fields(cert):
    return (cert.mode, cert.n_valid, cert.counts.tolist(), cert.feasible,
            cert.violations)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_certificates_match_jax(mode, masked):
    from repro.analysis import sanitize as ref_san
    from repro.core.optimizer import DualSolver as JaxSolver
    from repro.core.optimizer import init_dual_state as jax_init
    from repro_torch.core.optimizer import DualSolver, init_dual_state
    rng = np.random.RandomState(7)
    m = 4
    windows = []
    for nv in (21, 16, 11):
        n = 32 if masked else nv
        c = np.zeros((n, m), np.float32)
        q = np.zeros((n, m), np.float32)
        c[:nv] = rng.rand(nv, m)
        q[:nv] = rng.rand(nv, m)
        if masked:
            c[nv:], q[nv:] = 7.0, 0.5        # garbage in the padding
        windows.append((c, q, np.full(m, float(nv // 2 + 1), np.float32),
                        nv))
    kw = dict(mode=mode, iters=80, lr_constraint=3.0 if mode == "quality"
              else 50.0, stall_tol=1e-2, norm_grad=True)
    certs = {}
    for tag, pkg, solver, st0 in (
            ("jax", ref_san, JaxSolver(**kw), jax_init(m)),
            ("port", sanitize, DualSolver(**kw, device="cpu"),
             init_dual_state(m, "cpu"))):
        with pkg.enabled("ledgersan", "solvecert"):
            c0 = pkg.counters["certs"]
            _stream_certs(solver, st0, windows, mode, masked)
            n_new = pkg.counters["certs"] - c0
            assert n_new == len(windows), tag
            certs[tag] = list(pkg.last_certificates)[-n_new:]
    for cj, cp in zip(certs["jax"], certs["port"]):
        assert cp.ok and cj.ok
        assert _cert_fields(cp) == _cert_fields(cj)
        for f in ("csum", "qsum", "t_eff"):
            assert getattr(cp, f) == pytest.approx(getattr(cj, f), rel=1e-5,
                                                   abs=1e-6), f
        assert cp.lam == pytest.approx(cj.lam, rel=1e-3, abs=1e-7)


def test_a_replaced_ledger_and_an_over_capacity_assignment_raise_in_both(
        monkeypatch):
    from repro.analysis import sanitize as ref_san
    from repro.core import optimizer as ref_opt
    from repro_torch.core import optimizer as port_opt
    cost, qual, loads = _window_instance(seed=5, n=12)
    tight = np.array([3.0, 3.0, 3.0, 3.0], np.float32)
    for pkg, opt, kw in ((ref_san, ref_opt, {}),
                         (sanitize, port_opt, dict(device="cpu"))):
        # a ledger replaced between windows: the cumulative audit fires
        solver = opt.DualSolver(mode="budget", iters=40, **kw)
        st0 = (opt.init_dual_state(4) if not kw
               else opt.init_dual_state(4, "cpu"))
        _, info, st1 = solver.route_window(cost, qual, 6.0, loads, st0)
        audit = pkg.LedgerSan(mode="budget", threshold=6.0)
        csum = float(np.asarray(st1.budget_spent))
        audit.observe(st0, st1, csum=csum, iters_run=float(
            np.asarray(info.iters_run)))
        tampered = st1._replace(budget_spent=st1.budget_spent * 0.5)
        _, info2, st2 = solver.route_window(cost, qual, 6.0, loads, tampered)
        with pytest.raises(pkg.LedgerSanError, match="independent sum"):
            audit.observe(tampered, st2, csum=float(np.asarray(
                st2.budget_spent)) - float(np.asarray(tampered.budget_spent)),
                iters_run=float(np.asarray(info2.iters_run)))
        # an assignment that breaks capacity: SolveCert fires in the hook
        real = opt.DualSolver.route_arrays

        def crammed(self, cost, quality, *a, _real=real, **k):
            x, info = _real(self, cost, quality, *a, **k)
            return x * 0, info                  # everything on model 0

        monkeypatch.setattr(opt.DualSolver, "route_arrays", crammed)
        with pkg.enabled("solvecert"):
            with pytest.raises(pkg.SolveCertError, match="capacity"):
                solver.route_window(cost, qual, 6.0, tight, st0)
        monkeypatch.undo()


# ---------------------------------------------------------------------------
# schedule race checker
# ---------------------------------------------------------------------------

def test_racecheck_wake_at_in_past_fires():
    """The documented livelock hazard: ControlLoop._wake_at must only hand
    the executor strictly-future deadlines."""
    from repro_torch.analysis.sanitize import racecheck
    from repro_torch.core.baselines import BalanceAware
    from repro_torch.serving.engine import MultiLLMServer

    srv = MultiLLMServer([_OrderLeakEndpoint(0, [0])], BalanceAware(),
                         batch_size=2)
    cls = racecheck._engine_executor_cls(np.random.RandomState(0))
    ex = cls(srv, 10)
    with pytest.raises(racecheck.RaceCheckError, match="strictly future"):
        ex.advance(0.0)
    with pytest.raises(racecheck.RaceCheckError, match="strictly future"):
        ex.advance(-1.0)


class _OrderLeakEndpoint:
    """Deliberately order-dependent fake endpoint: each serviced chunk
    emits a POOL-GLOBAL sequence number, so any change in the executor's
    endpoint servicing order changes the outputs."""
    L = 2

    def __init__(self, idx, clock):
        self.idx = idx
        self.clock = clock          # shared mutable counter
        self.reqs = []

    def active_count(self):
        return len(self.reqs)

    def has_capacity(self):
        return len(self.reqs) < self.L

    def active_requests(self):
        return list(self.reqs)

    def can_serve(self, req):
        return True

    def admit(self, req):
        req.output = []
        self.reqs.append(req)

    def cancel(self, req):
        if req in self.reqs:
            self.reqs.remove(req)
            return True
        return False

    def step_begin(self):
        return list(self.reqs) or None

    def step_end(self, pending):
        done = []
        for r in pending or []:
            self.clock[0] += 1
            r.output.append(self.clock[0])   # leaks global service order
            if len(r.output) >= r.max_new:
                r.done = True
                self.reqs.remove(r)
                done.append(r)
        return done


def test_racecheck_flags_order_dependent_pool():
    from repro_torch.analysis.sanitize import racecheck
    from repro_torch.core.baselines import BalanceAware
    from repro_torch.serving.engine import (MultiLLMServer, Request,
                                            null_route_features)
    assert (np.random.RandomState(0).permutation(3).tolist()
            != np.random.RandomState(1).permutation(3).tolist())

    def make_server():
        clock = [0]
        eps = [_OrderLeakEndpoint(i, clock) for i in range(3)]
        srv = MultiLLMServer(eps, BalanceAware(), batch_size=3)
        for rid in range(6):
            srv.submit(Request(rid=rid, tokens=np.array([1, 2]), max_new=2))
        return srv, null_route_features

    with pytest.raises(racecheck.RaceCheckError,
                       match="depend on same-timestamp event ordering"):
        racecheck.explore_engine_schedules(make_server, seeds=(0, 1))


def test_racecheck_engine_pool_is_interleaving_independent():
    """Known-good, real engine: a hedged 2-endpoint float32 pool (gemma3-4b
    in the place of the reference's hymba member)
    produces identical outputs under permuted chunk/completion/hedge
    orderings, every request completes exactly once, and both allocators
    drain (PageSan-audited)."""
    from repro_torch.analysis.sanitize import racecheck
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.baselines import BalanceAware
    from repro_torch.serving.engine import (Endpoint, MultiLLMServer,
                                            Request, null_route_features)

    with sanitize.enabled("pagesan"):
        events0 = sanitize.counters["events"]
        eps = [Endpoint(dataclasses.replace(get_smoke_config(a),
                                            dtype=torch.float32),
                        max_concurrency=2, t_max=32, page_size=8,
                        sync_every=2, seed=i, device="cpu")
               for i, a in enumerate(["h2o-danube-3-4b", "gemma3-4b"])]
        assert all(ep.alloc.san is not None for ep in eps)
        rng = np.random.RandomState(3)
        prompts = [rng.randint(1, 500, (9,)).astype(np.int32)
                   for _ in range(4)]

        def make_server():
            srv = MultiLLMServer(eps, BalanceAware(), batch_size=2,
                                 hedge_after_steps=2)
            for i, p in enumerate(prompts):
                srv.submit(Request(rid=i, tokens=p, max_new=6))
            return srv, null_route_features

        report = racecheck.explore_engine_schedules(make_server,
                                                    seeds=(0, 1, 2))
        assert sanitize.counters["events"] > events0
    assert report.runs == 3
    assert len(report.fingerprint) == len(prompts)


def test_racecheck_sim_tie_storm_is_interleaving_independent():
    """Equal service times everywhere: completions pop in a fully permuted
    order per seed, yet assignment and realized cost must not move (loads
    ample, so every query routes up front)."""
    from repro_torch.analysis.sanitize import racecheck
    from repro_torch.core import BalanceAware, SchedulerConfig
    from repro_torch.data.qaserve import generate

    def make_args():
        ds = generate(n=16, seed=0)
        ds.out_len[:, :] = 40                  # maximal finish-time ties
        return ds, BalanceAware(), SchedulerConfig(loads=8, seed=3)

    report = racecheck.explore_sim_schedules(make_args, seeds=(0, 1, 2))
    assert report.runs == 3


def test_racecheck_sim_hedged_straggler_is_interleaving_independent():
    from repro_torch.analysis.sanitize import racecheck
    from repro_torch.core import BalanceAware, SchedulerConfig
    from repro_torch.data.qaserve import generate

    def make_args():
        ds = generate(n=16, seed=0)
        ds.out_len[:, :] = (40 + 3 * np.arange(16)[:, None]
                            + np.arange(ds.m)[None, :])
        ds.out_len[3, :] = 1200
        return ds, BalanceAware(), SchedulerConfig(loads=4, seed=3,
                                                   hedge=True,
                                                   hedge_factor=2.0)

    report = racecheck.explore_sim_schedules(make_args, seeds=(0, 1, 2))
    assert report.runs == 3


def test_racecheck_sim_matches_jax_fingerprint():
    """The port's simulator explorer and the reference's reach the same
    end state on the same tie storm."""
    from repro.analysis.sanitize import racecheck as ref_rc
    from repro.core import BalanceAware as JaxBA
    from repro.core import SchedulerConfig as JaxCfg
    from repro.data.qaserve import generate as jax_generate
    from repro_torch.analysis.sanitize import racecheck
    from repro_torch.core import BalanceAware, SchedulerConfig
    from repro_torch.data.qaserve import generate

    def args(gen, ba, cfg):
        def make_args():
            ds = gen(n=16, seed=0)
            ds.out_len[:, :] = 40
            return ds, ba(), cfg(loads=8, seed=3)
        return make_args

    got = racecheck.explore_sim_schedules(
        args(generate, BalanceAware, SchedulerConfig), seeds=(0, 1))
    want = ref_rc.explore_sim_schedules(
        args(jax_generate, JaxBA, JaxCfg), seeds=(0, 1))
    assert got.fingerprint == want.fingerprint
