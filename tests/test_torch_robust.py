"""The port's robust (lower-confidence-bound) streaming solve.

``DualSolver(robust=True, kappa=κ).route_window`` solves against
``q − κ·σ`` (σ the explicit ``quality_std``, else the Bernoulli std of the
clipped quality), taken before the path is chosen:

- κ = 0 is bit-identical to robust off (``q − 0·σ`` is exact for finite
  σ): ``x``, ``iters_run`` and every field of the carried state with
  ``torch.equal``, both modes, ``shards`` 1 and 4 (the blocked solve over
  padded windows), warm across three windows, with and without an
  explicit ``quality_std``;
- κ > 0 against the JAX solver, both modes, the whole and the padded
  blocked window, with and without ``quality_std``: ``x`` and
  ``iters_run`` exact, the ledger within 1e-5 relative and λ/λ2 within
  1e-3 relative (ROADMAP C4: XLA and PyTorch sum float32 in another
  order, and the normalized ascent amplifies it);
- ``OmniRouter(robust=True)`` over ECCOS-R against the JAX router, with
  and without a speculative pair column (the bound is taken after the
  pair columns are spliced in), over three padded windows: ``x`` exact;
  at κ = 0 the port's router equals its robust-off router bit for bit;
- κ < 0 raises.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jax_core  # noqa: E402
from repro.core import optimizer as jopt  # noqa: E402
from repro.core.baselines import pad_batch as jax_pad  # noqa: E402
from repro.core.speculative import SpecPair as JaxPair  # noqa: E402
from repro.data.qaserve import generate as jax_generate  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.core import optimizer as popt  # noqa: E402
from repro_torch.core.baselines import pad_batch, pad_bucket  # noqa: E402
from repro_torch.core.speculative import SpecPair  # noqa: E402
from repro_torch.data.qaserve import generate  # noqa: E402

STATE = ("lam", "lam_load", "budget_spent", "sr_deficit", "steps")
WINDOWS = ((128, 100), (128, 128), (128, 77))     # (padded, valid) rows
THRESHOLD = {"quality": 0.55, "budget": 0.2}


def _window(n_pad, nv, m=5, seed=0):
    """A window of ``nv`` valid rows padded to ``n_pad`` with garbage, and
    an explicit per-entry std."""
    rng = np.random.default_rng(seed)
    cost = rng.uniform(10, 20, (n_pad, m)).astype(np.float32)
    qual = rng.uniform(0, 1, (n_pad, m)).astype(np.float32)
    cost[:nv] = rng.uniform(0.2, 3.0, (nv, m)) * 1e-3
    std = rng.uniform(0.0, 0.3, (n_pad, m)).astype(np.float32)
    return cost, qual, std


def _solvers(mode, shards, **kw):
    return dict(mode=mode, iters=60, lr_constraint=3.0, stall_tol=1e-2,
                norm_grad=True, shards=shards, **kw)


def _close(a, b, rtol):
    return np.allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                       rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("explicit_std", [False, True])
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_kappa0_is_bit_identical_to_robust_off(mode, shards, explicit_std):
    base = popt.DualSolver(**_solvers(mode, shards), device="cpu")
    rob = dataclasses.replace(base, robust=True, kappa=0.0)
    loads = np.full(5, 30.0, np.float32)
    s0 = s1 = None
    for w, (n_pad, nv) in enumerate(WINDOWS):
        c, q, std = _window(n_pad, nv, seed=w)
        kw = dict(share=1.0 / (3 - w), polish_margin=0.03,
                  n_valid=nv if shards > 1 else None)
        x0, i0, s0 = base.route_window(c, q, THRESHOLD[mode], loads, s0, **kw)
        x1, i1, s1 = rob.route_window(
            c, q, THRESHOLD[mode], loads, s1,
            quality_std=std if explicit_std else None, **kw)
        assert torch.equal(x0, x1), w
        assert torch.equal(i0.iters_run, i1.iters_run), w
        for f in STATE:
            assert torch.equal(getattr(s0, f), getattr(s1, f)), (w, f)


@pytest.mark.parametrize("explicit_std", [False, True])
@pytest.mark.parametrize("layout", ["whole", "padded"])
@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_kappa_matches_jax(mode, layout, explicit_std):
    shards = 4 if layout == "padded" else 1
    kw = _solvers(mode, shards, robust=True, kappa=0.7)
    jsolver, psolver = jopt.DualSolver(**kw), popt.DualSolver(**kw,
                                                              device="cpu")
    loads = np.full(5, 30.0, np.float32)
    js = ps = None
    for w, (n_pad, nv) in enumerate(WINDOWS):
        c, q, std = _window(n_pad, nv, seed=10 + w)
        if layout == "whole":
            c, q, std = c[:nv], q[:nv], std[:nv]
        call = dict(share=1.0 / (3 - w), polish_margin=0.03,
                    n_valid=nv if layout == "padded" else None,
                    quality_std=std if explicit_std else None)
        xj, ij, js = jsolver.route_window(c, q, THRESHOLD[mode], loads, js,
                                          **call)
        xp, ip, ps = psolver.route_window(c, q, THRESHOLD[mode], loads, ps,
                                          **call)
        assert np.array_equal(xp.numpy(), np.asarray(xj)), w
        assert int(ip.iters_run) == int(ij.iters_run), w
        for f in ("budget_spent", "sr_deficit", "steps"):
            assert _close(getattr(ps, f), getattr(js, f), 1e-5), (w, f)
        assert _close(ps.lam, js.lam, 1e-3)
        assert _close(ps.lam_load, js.lam_load, 1e-3)
    # the bound moved the solve: the LCB ledger differs from robust off
    plain = popt.DualSolver(**_solvers(mode, shards), device="cpu")
    c, q, _ = _window(*WINDOWS[0], seed=10)
    if layout == "whole":
        c, q = c[:WINDOWS[0][1]], q[:WINDOWS[0][1]]
    nv = WINDOWS[0][1] if layout == "padded" else None
    _, _, s_plain = plain.route_window(c, q, THRESHOLD[mode], loads,
                                       n_valid=nv)
    _, _, s_rob = psolver.route_window(c, q, THRESHOLD[mode], loads,
                                       n_valid=nv)
    if mode == "quality":
        assert float(s_rob.sr_deficit) > float(s_plain.sr_deficit)


@pytest.fixture(scope="module")
def stores():
    (train_j, val_j, _), (train_p, val_p, _) = (
        jax_generate(n=540, seed=0).split(), generate(n=540, seed=0).split())
    return (jax_core.RetrievalPredictor(k=8).fit(train_j), val_j,
            port_core.RetrievalPredictor(k=8, device="cpu").fit(train_p),
            val_p)


@pytest.mark.parametrize("pairs", [(), ((0, 1, 4),)])
@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_robust_router_windows_match_jax(stores, mode, pairs):
    pj, val_j, pp, val_p = stores
    kw = (dict(alpha=0.7) if mode == "quality" else
          dict(budget=float(val_p.cost_matrix().min(1).sum() * 1.6)))
    jr = jax_core.OmniRouter(pj, jax_core.RouterConfig(
        robust=True, kappa=0.5, shards=4,
        spec_pairs=tuple(JaxPair(*p) for p in pairs), **kw))
    routers = [port_core.OmniRouter(pp, port_core.RouterConfig(
        robust=robust, kappa=kappa, shards=4,
        spec_pairs=tuple(SpecPair(*p) for p in pairs), **kw))
        for robust, kappa in ((True, 0.5), (True, 0.0), (False, 1.0))]
    js, states = None, [None] * 3
    start = 0
    for w, nv in enumerate((37, 32, 25)):
        sub_j = val_j.subset(np.arange(start, start + nv))
        sub_p = val_p.subset(np.arange(start, start + nv))
        start += nv
        n_pad = pad_bucket(nv, 4)
        # pair columns take loads and counts over all M + P columns
        cols = dict(loads=np.full(sub_p.m + len(pairs), 20.0),
                    counts=np.zeros(sub_p.m + len(pairs)))
        rb = dataclasses.replace(sub_j.route_batch(cols["loads"]), **cols)
        xj, js = jr.route_window(jax_pad(rb, n_pad), js,
                                 share=1.0 / (3 - w), n_valid=nv)
        xs = []
        for r, router in enumerate(routers):
            pb = pad_batch(dataclasses.replace(
                sub_p.route_batch(cols["loads"]), **cols), n_pad)
            x, states[r] = router.route_window(pb, states[r],
                                               share=1.0 / (3 - w),
                                               n_valid=nv)
            xs.append(x[:nv])
        assert np.array_equal(xs[0], np.asarray(xj)[:nv]), w
        assert np.array_equal(xs[1], xs[2]), w
        for f in STATE:
            assert torch.equal(getattr(states[1], f),
                               getattr(states[2], f)), (w, f)
    assert routers[0].dual_iters == int(float(js.steps))


def test_negative_kappa_raises():
    with pytest.raises(ValueError, match="kappa"):
        popt.DualSolver(robust=True, kappa=-0.1)
    with pytest.raises(ValueError, match="kappa"):
        port_core.OmniRouter(None, port_core.RouterConfig(robust=True,
                                                          kappa=-1.0))
