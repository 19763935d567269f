"""The serving engine's failure plane against the JAX package.

Two float32 smoke endpoints (h2o-danube-3-4b and gemma3-4b; the JAX
reference's own tests pair danube with hymba, which the port has since
its recurrent slice, but these pools kept gemma3-4b) on the same
parameters, behind ``MultiLLMServer``, in lockstep with
the JAX server:

- hedging (``hedge_after_steps`` 2 against 0): duplicates fire, every
  request completes once, the outputs equal the unhedged run's and JAX's,
  and no hedge or shadow copy is left at the end;
- a mid-stream death (endpoint 0 hard down from chunk 6, health, the
  stall watchdog): the watchdog cancels the stranded requests, they retry
  on the survivor, and the retries, failures, breaker trips and states
  equal JAX's;
- transient ``error_rate`` flakes, with and without a retry budget that
  can run out: the same failures, retries and completion order;
- rate limits and latency spikes: the same completions;
- hedging, a hard-down window, flakes, health and the watchdog together;
- ``fold_online`` behind ``OmniRouter(RetrievalPredictor)``, then the
  manual ``_fold`` entry point (held back below ``fold_chunk``, then
  forced): the folded store equals JAX's (size and labels exact,
  embeddings within 1e-6: the featurizers sum each row in another
  order), and ``folded`` is equal.

Every run compares, per completed request in completion order, the
request id, endpoint, output and ``failed`` flag, and the server's
``failures``, ``retries`` and ``hedged``, and every port allocator
drains back to full.  Greedy tokens are compared exactly: the logits
agree to ~1e-5, far inside these models' top-2 gaps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.core as jax_core  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.qaserve import DEFAULT_POOL as JAX_POOL  # noqa: E402
from repro.data.qaserve import generate as jax_generate  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import faults as jax_faults  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.qaserve import DEFAULT_POOL, generate  # noqa: E402
from repro_torch.serving import faults  # noqa: E402
from repro_torch.serving.engine import (Endpoint, MultiLLMServer,  # noqa: E402
                                        Request, null_route_features)

POOL = ("h2o-danube-3-4b", "gemma3-4b")
EP = dict(max_concurrency=2, t_max=32, page_size=8, sync_every=2)


def _endpoints():
    """(JAX endpoints, port endpoints) on the same float32 parameters."""
    jeps, peps = [], []
    for seed, arch in enumerate(POOL):
        jc = dataclasses.replace(jax_smoke(arch), dtype=jnp.float32)
        pc = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
        je = jax_engine.Endpoint(jc, seed=seed, **EP)
        je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
        jeps.append(je)
        peps.append(Endpoint(pc, params=convert.model_params_from_numpy(
            pc, jax.tree.map(np.asarray, je.params), "cpu"), device="cpu",
            **EP))
    return jeps, peps


def _plan(spec, seed):
    """The same fault plan in both packages: {endpoint: [(kind, kw)]}."""
    return tuple(mod.FaultPlan({j: tuple(mod.FaultSpec(kind, **kw)
                                         for kind, kw in specs)
                                for j, specs in spec.items()}, seed=seed)
                 for mod in (jax_faults, faults))


_CLASSES = ((jax_engine.MultiLLMServer, jax_engine.Request),
            (MultiLLMServer, Request))


def _drained(ep):
    return (ep.active_count() == 0
            and len(ep.alloc.free_pages) == ep.alloc.n_pages - 1
            and sorted(ep.alloc.free_slots) == list(range(ep.L))
            and not ep.block_table.any())


def _run(server_cls, request_cls, eps, policy, features, todo, **kw):
    srv = server_cls(eps, policy, batch_size=2, **kw)
    for rid, (toks, m) in enumerate(todo):
        srv.submit(request_cls(rid=rid, tokens=toks, max_new=m))
    done = srv.run(features, max_steps=600)
    trace = [(r.rid, r.endpoint, r.failed, list(r.output)) for r in done]
    return srv, trace


def _both(todo, jax_kw, port_kw, policies=None, features=None):
    """The same scenario on the JAX server and the port's; the traces and
    counters must be equal.  Returns (JAX server, port server, trace)."""
    jeps, peps = _endpoints()
    jpol, ppol = policies or (jax_core.BalanceAware(),
                              port_core.BalanceAware())
    jf, pf = features or (jax_engine.null_route_features,
                          null_route_features)
    js, want = _run(jax_engine.MultiLLMServer, jax_engine.Request, jeps,
                    jpol, jf, todo, **jax_kw)
    ps, got = _run(MultiLLMServer, Request, peps, ppol, pf, todo, **port_kw)
    assert got == want
    assert sorted(r for r, *_ in got) == list(range(len(todo)))
    assert (ps.failures, ps.retries, ps.hedged, ps.folded) == (
        js.failures, js.retries, js.hedged, js.folded)
    assert not ps._hedges and not ps._shadow_ids
    assert all(_drained(e) for e in peps)
    if js.health is not None:
        assert ps.health.trips == js.health.trips
        assert np.array_equal(ps.health.breaker_state,
                              js.health.breaker_state)
        assert np.array_equal(ps.health.fail_ewma, js.health.fail_ewma)
    return js, ps, got


def _prompts(n, seed, max_new=8):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 500, (9,)).astype(np.int32), max_new)
            for _ in range(n)]


def test_hedging_matches_jax_and_the_unhedged_run():
    todo = _prompts(3, seed=3, max_new=12)
    _, plain, unhedged = _both(todo, {}, {})
    _, ps, hedged = _both(todo, dict(hedge_after_steps=2),
                          dict(hedge_after_steps=2))
    assert ps.hedged > 0 and plain.hedged == 0
    # a lock-step pool: the primaries win, so the outputs are unchanged
    assert sorted(hedged) == sorted(unhedged)


def test_mid_stream_death_watchdog_matches_jax():
    todo = _prompts(6, seed=3, max_new=12)
    jplan, pplan = _plan({0: [("hard_down", dict(start=6.0))]}, seed=0)
    kw = dict(health=True, retry_budget=4, backoff_steps=2.0,
              stall_after_chunks=3)
    js, ps, got = _both(todo, dict(fault_plan=jplan, **kw),
                        dict(fault_plan=pplan, **kw))
    assert ps.retries > 0 and ps.failures == 0
    assert ps.health.trips >= 1
    assert all(ep == 1 for _, ep, _, _ in got[-2:])  # the survivor served


@pytest.mark.parametrize("budget", [3, 0])
def test_error_rate_flakes_match_jax(budget):
    todo = _prompts(6, seed=4)
    jplan, pplan = _plan({0: [("error_rate", dict(rate=0.3))],
                          1: [("error_rate", dict(rate=0.1))]}, seed=2)
    kw = dict(health=True, retry_budget=budget, backoff_steps=1.0)
    _, ps, got = _both(todo, dict(fault_plan=jplan, **kw),
                       dict(fault_plan=pplan, **kw))
    assert ps.retries + ps.failures > 0
    if budget == 0:
        assert ps.retries == 0 and ps.failures > 0
        assert sum(f for _, _, f, _ in got) == ps.failures


def test_rate_limit_and_latency_match_jax():
    todo = _prompts(6, seed=5)
    spike = dict(factor=3.0, start=2.0, end=12.0)
    jplan, pplan = _plan({0: [("rate_limit", dict(capacity=1))],
                          1: [("latency_spike", spike)]}, seed=0)
    faults.reset_counters()
    _both(todo, dict(fault_plan=jplan, health=True),
          dict(fault_plan=pplan, health=True))
    assert faults.counters["injected"] > 0


def test_hedging_faults_health_and_watchdog_together_match_jax():
    todo = _prompts(5, seed=5)
    jplan, pplan = _plan({0: [("hard_down", dict(start=6.0, end=40.0))],
                          1: [("error_rate", dict(rate=0.05))]}, seed=1)
    kw = dict(hedge_after_steps=4, health=True, retry_budget=3,
              backoff_steps=2.0, stall_after_chunks=3)
    _, ps, _ = _both(todo, dict(fault_plan=jplan, **kw),
                     dict(fault_plan=pplan, **kw))
    assert ps.retries > 0


def test_fold_online_grows_the_same_store():
    pool_j, pool_p = JAX_POOL[:2], DEFAULT_POOL[:2]
    store_j = jax_generate(n=300, seed=0, pool=pool_j)
    store_p = generate(n=300, seed=0, pool=pool_p)
    ds_j = jax_generate(n=10, seed=5, pool=pool_j)
    ds_p = generate(n=10, seed=5, pool=pool_p)
    rj = jax_core.RetrievalPredictor(k=8).fit(store_j)
    rp = port_core.RetrievalPredictor(k=8, device="cpu").fit(store_p)
    pols = (jax_core.OmniRouter(rj, jax_core.RouterConfig(alpha=0.7)),
            port_core.OmniRouter(rp, port_core.RouterConfig(alpha=0.7)))
    feats = (lambda reqs: ds_j.subset(np.array([r.rid for r in reqs])),
             lambda reqs: ds_p.subset(np.array([r.rid for r in reqs])))
    todo = _prompts(ds_p.n, seed=6, max_new=6)
    js, ps, _ = _both(todo, dict(fold_online=True), dict(fold_online=True),
                      policies=pols, features=feats)
    assert ps.folded == ds_p.n
    jv, pv = rj.vstore, rp.vstore
    assert pv.size == jv.size == store_p.n + ds_p.n
    assert int(pv.n_valid) == int(jv.n_valid)
    # the manual entry point folds what did not flow through run()
    for srv, (_, req_cls) in ((js, _CLASSES[0]), (ps, _CLASSES[1])):
        srv._fold_buf.extend(req_cls(rid=i, tokens=t, max_new=m)
                             for i, (t, m) in enumerate(todo[:1]))
    js._fold(feats[0])
    ps._fold(feats[1])              # below fold_chunk (2): waits
    assert ps.folded == js.folded == ds_p.n and len(ps._fold_buf) == 1
    js._fold(feats[0], force=True)
    ps._fold(feats[1], force=True)
    assert ps.folded == js.folded == ds_p.n + 1 and not ps._fold_buf
    n = pv.size
    assert n == jv.size == store_p.n + ds_p.n + 1
    assert np.array_equal(pv.labels.numpy()[:n], np.asarray(jv.labels)[:n])
    assert np.abs(pv.emb.numpy()[:n] - np.asarray(jv.emb)[:n]).max() <= 1e-6
