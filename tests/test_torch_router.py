"""The port's router end to end against the JAX package.

On ``generate(n=540, seed=0).split()`` a JAX ``HybridPredictor`` is fitted
for 20 steps, and its parameters and vector store are carried into the
port:

- (a) the JAX predictor's NumPy capability/cost routed through the port's
  ``DualSolver.route_arrays`` give JAX's assignment exactly, in both modes;
- (b) the port's ``OmniRouter.route`` agrees with the JAX router on >= 99%
  of rows, with success rate and $ within 1% (the two predictors sum their
  float32 encoders in another order, which may move a near-tie);
- (c) three ``route_window`` calls carry a ``DualState`` whose ledger
  (budget spent, quality deficit, steps) matches JAX within 1e-5 relative;
- (d) the same three windows padded to power-of-two buckets and masked by
  ``n_valid``, at ``shards`` 4 (the blocked solve): ``x`` exact, the ledger
  within 1e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.core import DualSolver as JaxSolver  # noqa: E402
from repro.core import HybridPredictor as JaxHybrid  # noqa: E402
from repro.core import OmniRouter as JaxRouter  # noqa: E402
from repro.core import PredictorConfig as JaxPCfg  # noqa: E402
from repro.core import RouterConfig as JaxRCfg  # noqa: E402
from repro.core import evaluate_assignment as jax_eval  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro.core.baselines import pad_batch as jax_pad  # noqa: E402
from repro.core.baselines import pad_bucket as jax_bucket  # noqa: E402
from repro_torch.core import (DualSolver, HybridPredictor, OmniRouter,  # noqa: E402
                              PredictorConfig, RouteBatch, RouterConfig,
                              evaluate_assignment, pad_batch, pad_bucket)


@pytest.fixture(scope="module")
def carried(qaserve_splits):
    train, _, _ = qaserve_splits
    ref = JaxHybrid(JaxPCfg(n_models=train.m)).fit(train, steps=20, batch=48)
    port = HybridPredictor(
        PredictorConfig(n_models=train.m),
        params=convert.predictor_params_from_numpy(
            jax.tree.map(np.asarray, ref.trained.params), "cpu"),
        device="cpu")
    vs = ref.retrieval.vstore
    port.retrieval.vstore = convert.vector_store_from_numpy(
        np.asarray(vs.emb), np.asarray(vs.labels), vs.size, "cpu")
    return ref, port


def _port_batch(rb):
    return RouteBatch(rb.queries, rb.input_len, rb.price_in, rb.price_out,
                      rb.loads, rb.counts, rb.cost_true, rb.correct_true)


def _cfgs(mode, ds):
    if mode == "quality":
        return dict(alpha=0.7)
    return dict(budget=float(ds.cost_matrix().min(axis=1).sum() * 1.6))


@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_a_route_arrays_on_jax_predictions_is_exact(carried, qaserve_splits,
                                                    mode):
    ref, _ = carried
    _, val, _ = qaserve_splits
    cap, _, cost = ref.predict_arrays(val)
    loads = np.full(val.m, float(val.n // 4))
    kw = dict(mode=mode, lr_constraint=4.0 if mode == "quality" else 50.0)
    thr = (0.7 if mode == "quality"
           else float(cost.min(axis=1).sum() * 1.6))
    pt = min(thr + 0.03, 1.0) if mode == "quality" else None
    xj, _ = JaxSolver(**kw).route_arrays(cost, cap, thr, loads,
                                         polish_threshold=pt)
    xp, _ = DualSolver(**kw, device="cpu").route_arrays(
        cost, cap, thr, loads, polish_threshold=pt)
    assert np.array_equal(xp.numpy(), np.asarray(xj))
    assert np.all(np.bincount(xp.numpy(), minlength=val.m) <= loads)


@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_b_router_route_agrees_with_jax(carried, qaserve_splits, mode):
    ref, port = carried
    _, val, test = qaserve_splits
    agree = []
    for ds in (val, test):
        loads = np.full(ds.m, float(ds.n // 4))
        rb = ds.route_batch(loads)
        xj = JaxRouter(ref, JaxRCfg(**_cfgs(mode, ds))).route(rb)
        router = OmniRouter(port, RouterConfig(**_cfgs(mode, ds)))
        xp = router.route(_port_batch(rb))
        assert xp.shape == (ds.n,)
        assert np.all(np.bincount(xp, minlength=ds.m) <= loads)
        agree.append(xp == np.asarray(xj))
        rj, rp = jax_eval(ds, xj), evaluate_assignment(ds, xp)
        assert rp["success_rate"] == pytest.approx(rj["success_rate"],
                                                   rel=0.01)
        assert rp["cost"] == pytest.approx(rj["cost"], rel=0.01)
        assert set(router.last_timing) >= {"tokenize_s", "predict_solve_s",
                                           "polish_s"}
    assert np.concatenate(agree).mean() >= 0.99


@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_c_route_window_ledger_matches_jax(carried, qaserve_splits, mode):
    ref, port = carried
    _, val, _ = qaserve_splits
    kw = _cfgs(mode, val)
    jr, pr = JaxRouter(ref, JaxRCfg(**kw)), OmniRouter(port, RouterConfig(**kw))
    js = ps = None
    w = val.n // 3
    for k in range(3):
        sub = val.subset(np.arange(k * w, (k + 1) * w))
        rb = sub.route_batch(np.full(sub.m, float(w // 3)))
        xj, js = jr.route_window(rb, js, share=1.0 / (3 - k))
        xp, ps = pr.route_window(_port_batch(rb), ps, share=1.0 / (3 - k))
        assert np.array_equal(xp, np.asarray(xj)), k
        for field in ("budget_spent", "sr_deficit", "steps"):
            assert np.allclose(float(getattr(ps, field)),
                               float(getattr(js, field)), rtol=1e-5,
                               atol=1e-9), (k, field)
    assert pr.windows == 3 and pr.dual_iters == int(float(ps.steps))


@pytest.mark.parametrize("mode", ["quality", "budget"])
def test_d_padded_windows_match_jax(carried, qaserve_splits, mode):
    ref, port = carried
    _, val, _ = qaserve_splits
    kw = dict(_cfgs(mode, val), shards=4)
    jr, pr = JaxRouter(ref, JaxRCfg(**kw)), OmniRouter(port, RouterConfig(**kw))
    assert pr.window_multiple() == 4
    js = ps = None
    start = 0
    for k, nv in enumerate((37, 32, 25)):
        sub = val.subset(np.arange(start, start + nv))
        start += nv
        rb = sub.route_batch(np.full(sub.m, 20.0))
        n_pad = pad_bucket(nv, 4)
        assert n_pad == jax_bucket(nv, 4) and n_pad % 4 == 0
        xj, js = jr.route_window(jax_pad(rb, n_pad), js, share=1.0 / (3 - k),
                                 n_valid=nv)
        xp, ps = pr.route_window(pad_batch(_port_batch(rb), n_pad), ps,
                                 share=1.0 / (3 - k), n_valid=nv)
        assert np.array_equal(xp[:nv], np.asarray(xj)[:nv]), k
        for field in ("budget_spent", "sr_deficit", "steps"):
            assert np.allclose(float(getattr(ps, field)),
                               float(getattr(js, field)), rtol=1e-5,
                               atol=1e-9), (k, field)

