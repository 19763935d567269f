"""The port's predictor training against the JAX package.

- ``repro_torch.training.AdamW`` against ``repro.training.optim.AdamW``
  on one seeded tree (a scalar, a vector and a 3-D leaf), five steps of
  the same seeded gradients, in fp32, bf16 and int8 moments, with the
  global-norm clip active and inactive: the returned norm within 1e-6
  relative, every parameter and moment leaf within 1e-6 of its largest
  element (the two sum the norm in another order, so the clip factor and
  each update move by an ulp or two; an update that brings a parameter
  near zero keeps that absolute error, which is large relative to the
  element alone), int8 ``q`` equal and its scales within 1e-6 relative.
- ``loss_fn`` at the JAX initial parameters (default widths): in float64
  the value and every gradient within 1e-10 of JAX's; in float32 the
  value within 1e-5 relative and every gradient as close to the float64
  gradient as JAX's float32 one is (see the test).  A gradient leaf is
  held relative to its largest element: sum-order rounding is absolute
  in size, and elements near zero carry none of it in relative terms.
- ``TrainedPredictor.fit`` from the JAX initial tree (``init=``), on
  ``generate(n=2700, seed=0).split()``'s training split with the
  reference's batch order: at narrow widths every loss of 20 steps within
  2e-6 relative; at the default widths step 1's loss within 1e-6 relative
  and, after 150 steps, every ``eval_accuracy`` field within 0.02 of the
  JAX fit's.  Past the first steps at the default widths AdamW's
  normalised step m/√v amplifies sum-order differences in gradients near
  zero, so the losses are not held step by step there.
- ``HybridPredictor.fit``: the store's size and labels equal to JAX's,
  its embeddings within 1e-6 (the two featurizers sum each row in
  another order: ~4e-8 apart on a quarter of the elements), the
  predictions of a narrow fit within 1e-4.
- ``S3Cost.route`` over a ``TrainedPredictor`` carrying a JAX-fitted
  tree equal to JAX's.

The port's fits run on one CPU thread: with several, PyTorch may sum a
reduction in another order from run to run, and the fits would differ
from run to run by as much as the tolerances allow.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.core as jcore  # noqa: E402
from repro.common import init_params as jax_init  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core import predictor as jpred  # noqa: E402
from repro.data.qaserve import generate as jax_generate  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
import repro_torch.core as pcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import predictor as ppred  # noqa: E402
from repro_torch.data import tokenizer  # noqa: E402
from repro_torch.data.qaserve import bucketize, generate  # noqa: E402
from repro_torch.training import AdamW, QTensor, tree_leaves  # noqa: E402

NARROW = dict(max_len=16, d_model=32, d_ff=64)


def _close(got, want, rel=1e-6):
    """``got`` (a tensor) within ``rel`` of ``want``'s largest element."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# -- AdamW --------------------------------------------------------------------

def _tree(rng, scale):
    return {"s": np.float32(rng.randn() * scale),
            "v": (rng.randn(7) * scale).astype(np.float32),
            "w": (rng.randn(3, 4, 5) * scale).astype(np.float32)}


@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no-clip"])
@pytest.mark.parametrize("moments", ["fp32", "bf16", "int8"])
def test_adamw_matches_jax(moments, clip):
    rng = np.random.RandomState(0)
    params = _tree(rng, 0.5)
    # gradients of norm ~7 (clip 1.0 active) or ~0.07 (inactive)
    grads = [_tree(rng, 1.0 if clip else 0.01) for _ in range(5)]
    kw = dict(learning_rate=1e-2, weight_decay=0.01, moment_dtype=moments,
              grad_clip=1.0)
    jopt, popt = joptim.AdamW(JaxTrainConfig(**kw)), AdamW(TrainConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    pp = {k: torch.tensor(v) for k, v in params.items()}
    ps = popt.init(pp)
    for g in grads:
        jp, js, jn = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        pn = popt.update({k: torch.tensor(v) for k, v in g.items()}, ps,
                         pp)
        assert (float(pn) >= 1.0) == clip
        np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
        for k in params:
            _close(pp[k], jp[k])
    assert ps["step"] == int(js["step"]) == 5
    for part in ("m", "v"):
        for k in params:
            got, want = ps[part][k], js[part][k]
            if moments == "int8":
                assert isinstance(got, QTensor)
                assert got.q.dtype == torch.int8
                assert np.array_equal(got.q.numpy(), np.asarray(want.q))
                np.testing.assert_allclose(got.scale.numpy(),
                                           np.asarray(want.scale), rtol=1e-6)
            else:
                assert str(got.dtype).split(".")[-1] == {
                    "fp32": "float32", "bf16": "bfloat16"}[moments]
                _close(got, want)


def test_quantize_round_trip_matches_jax():
    x = np.random.RandomState(1).randn(4, 9).astype(np.float32)
    x[1] = 0.0                              # an all-zero row: scale 1e-12
    x[2, 3] = 2.5 * np.abs(x[2]).max()      # a row whose max sets the scale
    got = joptim.quantize(jnp.asarray(x))
    want_q, want_s = np.asarray(got.q), np.asarray(got.scale)
    from repro_torch.training import dequantize, quantize
    t = quantize(torch.from_numpy(x))
    assert np.array_equal(t.q.numpy(), want_q)
    np.testing.assert_allclose(t.scale.numpy(), want_s, rtol=1e-6)
    np.testing.assert_allclose(dequantize(t).numpy(),
                               np.asarray(joptim.dequantize(got)), rtol=1e-6)
    s = quantize(torch.tensor(-3.0))        # a scalar leaf
    js = joptim.quantize(jnp.asarray(-3.0, jnp.float32))
    assert int(s.q) == int(js.q) and float(s.scale) == float(js.scale)


# -- the loss and the fit -----------------------------------------------------

@pytest.fixture(scope="module")
def splits():
    return jax_generate(n=2700, seed=0).split(), generate(n=2700,
                                                          seed=0).split()


@pytest.fixture
def one_thread():
    """The port's fits on one CPU thread: with several, PyTorch's CPU
    reductions (the embedding gradient's among them) may sum in another
    order from run to run, and a 150-step AdamW fit amplifies that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_init(cfg_kw, seed=0):
    return jax.tree.map(np.asarray, jax_init(
        jpred.predictor_decls(jpred.PredictorConfig(**cfg_kw)),
        jax.random.PRNGKey(seed)))


def _loss_and_grads(splits, dtype):
    """loss_fn's value and gradient leaves at the JAX initial parameters
    (default widths) on one seeded batch: (JAX, port), in ``dtype``."""
    (jtr, _, _), (ptr, _, _) = splits
    jcfg, pcfg = jpred.PredictorConfig(), ppred.PredictorConfig()
    init = _jax_init({})
    idx = np.random.RandomState(0).choice(jtr.n, size=64, replace=False)
    toks = tokenizer.encode_batch([ptr.queries[i] for i in idx],
                                  pcfg.max_len)
    lb = bucketize(ptr.out_len[idx], pcfg.n_buckets)
    with jax.enable_x64(dtype == "float64"):
        (jl, jaux), jg = jax.value_and_grad(
            lambda p: jpred.loss_fn(jcfg, p, {
                "tokens": jnp.asarray(toks),
                "correct": jnp.asarray(jtr.correct[idx]),
                "len_bucket": jnp.asarray(lb)}), has_aux=True)(
            jax.tree.map(lambda a: jnp.asarray(a, dtype), init))
        want = (float(jl), {k: float(v) for k, v in jaux.items()},
                [np.asarray(g) for g in jax.tree.leaves(jg)])
    params = jax.tree.map(
        lambda a: torch.tensor(a, dtype=getattr(torch, dtype),
                               requires_grad=True), init)
    flat = tree_leaves(params)
    pl, paux = ppred.loss_fn(pcfg, params, {
        "tokens": torch.from_numpy(toks),
        "correct": torch.from_numpy(ptr.correct[idx]),
        "len_bucket": torch.from_numpy(lb)})
    grads = [g.numpy() for g in torch.autograd.grad(pl, flat)]
    got = (float(pl.detach()), {k: float(v.detach())
                                for k, v in paux.items()}, grads)
    return want, got


def _leaf_err(a, b, ref):
    """Largest |a - b| over the leaf, as a share of ``ref``'s largest
    element."""
    return float(np.abs(a - b).max()) / max(float(np.abs(ref).max()), 1e-30)


def test_loss_and_gradients_match_jax(splits):
    """In float64 both compute the same function: value and every gradient
    leaf within 1e-10.  In float32 the value is held within 1e-5
    relative.  The gradients are not held to 1e-5 of each other: JAX's own
    float32 gradients lie up to ~1.2e-4 (of a leaf's largest element) from
    the float64 ones in the first layer and the embeddings, where the
    attention softmax amplifies rounding.  So every float32 leaf of the
    port is held within 1e-5 of the float64 gradient, or within three
    times JAX's own float32 distance to it where that is larger."""
    (w64, a64, g64), (p64, b64, q64) = _loss_and_grads(splits, "float64")
    assert abs(p64 - w64) <= 1e-10 * abs(w64)
    assert all(abs(b64[k] - a64[k]) <= 1e-10 * abs(a64[k]) for k in a64)
    assert len(g64) == len(q64) == 20
    for g, w in zip(q64, g64):
        assert g.shape == w.shape and _leaf_err(g, w, w) <= 1e-10
    (w32, a32, g32), (p32, b32, q32) = _loss_and_grads(splits, "float32")
    assert abs(p32 - w32) <= 1e-5 * abs(w32)
    assert all(abs(b32[k] - a32[k]) <= 1e-5 * abs(a32[k]) for k in a32)
    for g, w, ref in zip(q32, g32, g64):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert _leaf_err(g, ref, ref) <= max(1e-5,
                                             3 * _leaf_err(w, ref, ref))


def test_fit_narrow_matches_jax_losses(splits, one_thread):
    (jtr, _, _), (ptr, _, _) = splits
    jp = jpred.TrainedPredictor(jpred.PredictorConfig(**NARROW))
    want = np.array(jp.fit(jtr, steps=20, batch=64, seed=0))
    tp = ppred.TrainedPredictor(ppred.PredictorConfig(**NARROW),
                                device="cpu")
    got = np.array(tp.fit(ptr, steps=20, batch=64, seed=0, init=(
        convert.predictor_params_from_numpy(_jax_init(NARROW), "cpu"))))
    assert got.shape == want.shape == (20,)
    assert np.all(np.abs(got - want) <= 2e-6 * np.abs(want))
    # the trained tree reads back, detached, in the JAX layout
    tree = convert.predictor_params_to_numpy(tp.params)
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(np.asarray, jp.params))
    assert not any(t.requires_grad for t in tree_leaves(tp.params))


def test_fit_default_widths_matches_jax_accuracy(splits, one_thread):
    (jtr, _, jte), (ptr, _, pte) = splits
    jp = jpred.TrainedPredictor(jpred.PredictorConfig())
    want = jp.fit(jtr, steps=150, batch=64, seed=0)
    tp = ppred.TrainedPredictor(ppred.PredictorConfig(), device="cpu")
    got = tp.fit(ptr, steps=150, batch=64, seed=0, init=(
        convert.predictor_params_from_numpy(_jax_init({}), "cpu")))
    assert abs(got[0] - want[0]) <= 1e-6 * abs(want[0])
    assert np.all(np.isfinite(got))
    assert np.mean(got[-10:]) < np.mean(got[:10])
    acc_j, acc_p = jp.eval_accuracy(jte), tp.eval_accuracy(pte)
    assert acc_p.keys() == acc_j.keys()
    for k in acc_j:
        assert abs(acc_p[k] - acc_j[k]) <= 0.02, (k, acc_p[k], acc_j[k])


def test_hybrid_fit_matches_jax(splits, one_thread):
    (jtr, _, jte), (ptr, _, pte) = splits
    jh = jcore.HybridPredictor(jcore.PredictorConfig(**NARROW)).fit(
        jtr, steps=20, batch=64, seed=0)
    ph = pcore.HybridPredictor(pcore.PredictorConfig(**NARROW),
                               device="cpu").fit(
        ptr, steps=20, batch=64, seed=0,
        init=convert.predictor_params_from_numpy(_jax_init(NARROW), "cpu"))
    jv, pv = jh.retrieval.vstore, ph.retrieval.vstore
    assert pv.size == jv.size == jtr.n
    assert np.array_equal(pv.labels.numpy(), np.asarray(jv.labels))
    assert np.abs(pv.emb.numpy() - np.asarray(jv.emb)).max() <= 1e-6
    test = pte.subset(np.arange(128))
    for got, want in zip(ph.predict_arrays(test), jh.predict_arrays(
            jte.subset(np.arange(128)))):
        # expected lengths reach 1,024 and costs are ~1e-3: relative
        assert np.all(np.abs(got - want) <= 1e-4 * np.maximum(
            np.abs(want), 1.0))


def test_s3_routes_like_jax_over_a_jax_fitted_tree(splits):
    """The narrow config: its predicted costs have no near-ties between
    models, so the greedy argsort cannot flip on a float32 rounding."""
    (jtr, _, jte), _ = splits
    jp = jpred.TrainedPredictor(jpred.PredictorConfig(**NARROW))
    jp.fit(jtr, steps=20, batch=48, seed=0)
    js = jcore.S3Cost()
    js.pred = jp
    ps = pcore.S3Cost(device="cpu")
    ps.pred = ppred.TrainedPredictor(
        ppred.PredictorConfig(**NARROW), convert.predictor_params_from_numpy(
            jax.tree.map(np.asarray, jp.params), "cpu"), device="cpu")
    loads, counts = np.full(jte.m, 40.0), np.arange(jte.m, dtype=float)
    rb = jte.route_batch(loads, counts)
    pb = pcore.RouteBatch(rb.queries, rb.input_len, rb.price_in,
                          rb.price_out, rb.loads, rb.counts)
    want = js.route(rb, rng=np.random.RandomState(0))
    got = ps.route(pb, rng=np.random.RandomState(0))
    assert np.array_equal(got, want)
    assert len(np.unique(got)) > 1
