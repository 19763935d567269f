"""The port's event-driven serving simulator against the JAX package.

The same ``generate(n=540, seed=0)`` data and the same ``SchedulerConfig``
go through ``repro.core.run_serving`` and ``repro_torch.core.run_serving``
(the port on the CPU), and the two ``ServeResult`` s must be equal in every
field but ``scheduling_seconds`` (wall time): integers with ``==``, floats
with ``==`` on float64 (NumPy sums over the same assignment).  Cases:

- the baselines (balance-aware, oracle, random; the random one draws from
  the ``rng`` the controller threads into ``route``) in batching and
  streaming mode;
- ``OmniRouter(RetrievalPredictor(k=8))`` one-shot, and with
  ``streaming_dual=True`` under Poisson and bursty arrivals (no fault plan:
  the port's fault counters stay at 0);
- hedging (``RandomPolicy``, ``loads=2``);
- ``fold_online=True``: the same store size and label rows afterwards, the
  folded embeddings within 1e-5 (the two featurizers sum in another order);
- a fault plan (endpoint 0 hard down at t = 1, endpoint 1 erroring at rate
  0.6 over [0.5, 4)) in budget mode with ``robust=True``, with and without
  the health plane.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jax_core  # noqa: E402
from repro.data.qaserve import generate as jax_generate  # noqa: E402
from repro.serving import faults as jax_faults  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.data.qaserve import generate  # noqa: E402
from repro_torch.serving import faults  # noqa: E402

STREAM = dict(arrival_rate=40.0, window=0.25, streaming_dual=True,
              tokens_per_sec=600.0)


def assert_same_result(got, want):
    """Every field but the wall time, exactly."""
    for f in dataclasses.fields(want):
        if f.name == "scheduling_seconds":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif isinstance(b, float):
            assert isinstance(a, float) and a == b, (f.name, a, b)
        else:
            assert type(a) is type(b) and a == b, (f.name, a, b)


def run_both(ds_jax, ds_port, pol_jax, pol_port, **cfg):
    want = jax_core.run_serving(ds_jax, pol_jax,
                                jax_core.SchedulerConfig(**cfg))
    got = port_core.run_serving(ds_port, pol_port,
                                port_core.SchedulerConfig(**cfg))
    assert_same_result(got, want)
    return got


def predictors(train_jax, train_port):
    return (jax_core.RetrievalPredictor(k=8).fit(train_jax),
            port_core.RetrievalPredictor(k=8, device="cpu").fit(train_port))


@pytest.fixture(scope="module")
def data():
    return (jax_generate(n=540, seed=0).split(),
            generate(n=540, seed=0).split())


@pytest.fixture(scope="module")
def routers(data):
    """One JAX and one port ECCOS-R router (quality mode, alpha 0.7)."""
    (train_j, _, _), (train_p, _, _) = data
    pj, pp = predictors(train_j, train_p)
    return (jax_core.OmniRouter(pj, jax_core.RouterConfig(alpha=0.7)),
            port_core.OmniRouter(pp, port_core.RouterConfig(alpha=0.7)))


@pytest.mark.parametrize("mode", ["batching", "streaming"])
@pytest.mark.parametrize("policy", ["BalanceAware", "Oracle", "RandomPolicy"])
def test_baselines_serve_the_same(policy, mode):
    res = run_both(jax_generate(n=540, seed=0), generate(n=540, seed=0),
                   getattr(jax_core, policy)(), getattr(port_core, policy)(),
                   mode=mode, seed=2)
    assert res.per_model_counts.sum() == 540
    if mode == "streaming":
        assert res.windows == 540


@pytest.mark.parametrize("arrival", ["batch", "poisson", "bursty"])
def test_eccos_r_serves_the_same(data, routers, arrival):
    (_, val_j, _), (_, val_p, _) = data
    jr, pr = routers
    cfg = {} if arrival == "batch" else dict(STREAM, arrival=arrival)
    faults.reset_counters()
    res = run_both(val_j, val_p, jr, pr, **cfg)
    assert faults.counters == {"checks": 0, "injected": 0}
    assert res.per_model_counts.sum() == val_p.n
    if arrival == "batch":
        assert res.dual_iters == 0
    else:
        assert res.windows > 1 and res.dual_iters > 0


def test_hedging_serves_the_same():
    res = run_both(jax_generate(n=540, seed=0), generate(n=540, seed=0),
                   jax_core.RandomPolicy(), port_core.RandomPolicy(),
                   loads=2, seed=1, hedge=True, hedge_factor=2.0)
    assert res.hedged > 0


def test_fold_online_grows_the_same_store(data):
    (train_j, val_j, _), (train_p, val_p, _) = data
    pj, pp = predictors(train_j, train_p)
    n0 = pp.vstore.size
    run_both(val_j, val_p,
             jax_core.OmniRouter(pj, jax_core.RouterConfig(alpha=0.7)),
             port_core.OmniRouter(pp, port_core.RouterConfig(alpha=0.7)),
             fold_online=True, fold_chunk=16, arrival="poisson", **STREAM)
    n = pp.vstore.size
    assert n == pj.vstore.size == n0 + val_p.n
    assert pp.vstore.capacity == pj.vstore.capacity
    assert np.array_equal(pp.vstore.labels[:n].numpy(),
                          np.asarray(pj.vstore.labels)[:n])
    assert np.abs(pp.vstore.emb[:n].numpy()
                  - np.asarray(pj.vstore.emb)[:n]).max() < 1e-5


@pytest.mark.parametrize("health", [False, True])
def test_fault_plan_robust_budget_serves_the_same(health):
    pools = [generate(n=400, seed=3).split(0.5, 0.0, seed=0),
             jax_generate(n=400, seed=3).split(0.5, 0.0, seed=0)]
    (train_p, _, test_p), (train_j, _, test_j) = pools
    cost = test_p.cost_matrix()
    budget = 3.5 * float(np.delete(cost, (0, 1), axis=1).min(1).sum())
    pj, pp = predictors(train_j, train_p)
    kw = dict(budget=budget, robust=True, kappa=0.5)

    def plan(mod):
        return mod.FaultPlan(
            {0: (mod.FaultSpec("hard_down", start=1.0),),
             1: (mod.FaultSpec("error_rate", rate=0.6, start=0.5,
                               end=4.0),)}, seed=1)

    cfg = dict(arrival="poisson", arrival_rate=40.0, window=0.25,
               streaming_dual=True, horizon=test_p.n, health=health,
               retry_budget=3)
    want = jax_core.run_serving(
        test_j, jax_core.OmniRouter(pj, jax_core.RouterConfig(**kw)),
        jax_core.SchedulerConfig(fault_plan=plan(jax_faults), **cfg))
    faults.reset_counters()
    got = port_core.run_serving(
        test_p, port_core.OmniRouter(pp, port_core.RouterConfig(**kw)),
        port_core.SchedulerConfig(fault_plan=plan(faults), **cfg))
    assert_same_result(got, want)
    assert faults.counters["injected"] > 0 and got.retries > 0
    if health:
        assert got.breaker_trips >= 1 and got.failures == 0
    else:
        assert got.breaker_trips == 0 and got.failures > 0
