"""The port's ECCOS-T encoder and ECCOS-H blend against the JAX package.

JAX parameters (``init_params(predictor_decls(cfg), PRNGKey(0))``) carried
across with ``convert.predictor_params_from_numpy`` must give the same
``predict``: capability and length-bucket probabilities within 1e-5 (float32
matmuls and softmaxes summed in another order).  ``hybrid_predict_device``
over a shared store must match too: capability, cost and the blend weight
within 1e-5 (cost in $, ~1e-3); expected length within 1e-5 relative
(lengths reach 1024).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.common import init_params as jax_init  # noqa: E402
from repro.core import predictor as jpred  # noqa: E402
from repro.data import tokenizer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import predictor as ppred  # noqa: E402

SMALL = dict(n_models=6, max_len=16, d_model=32, n_layers=2, n_heads=4,
             d_ff=64, n_buckets=10)


def _jax_params(cfg_kw, seed=0):
    params = jax_init(jpred.predictor_decls(jpred.PredictorConfig(**cfg_kw)),
                      jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def batch(qaserve_small):
    ds = qaserve_small.subset(np.arange(48))
    return ds, tokenizer.encode_batch(ds.queries, 64)


@pytest.mark.parametrize("cfg_kw", [SMALL, {}], ids=["small", "default"])
def test_predict_with_carried_params_matches_jax(cfg_kw, batch):
    _, toks = batch
    jcfg = jpred.PredictorConfig(**cfg_kw)
    pcfg = ppred.PredictorConfig(**cfg_kw)
    np_params = _jax_params(cfg_kw)
    params = convert.predictor_params_from_numpy(np_params, "cpu")
    t = toks[:, :jcfg.max_len]
    cap_j, len_j = jpred.predict(jcfg, jax.tree.map(jnp.asarray, np_params),
                                 jnp.asarray(t))
    cap_p, len_p = ppred.predict(pcfg, params, torch.from_numpy(t))
    assert cap_p.shape == (t.shape[0], jcfg.n_models)
    assert len_p.shape == (t.shape[0], jcfg.n_models, jcfg.n_buckets)
    assert np.abs(cap_p.numpy() - np.asarray(cap_j)).max() < 1e-5
    assert np.abs(len_p.numpy() - np.asarray(len_j)).max() < 1e-5
    # the nn.Module holds the same tree and computes the same function
    net = ppred.PredictorNet(pcfg, params)
    cap_m, len_m = net(torch.from_numpy(t))
    assert torch.equal(cap_m, cap_p) and torch.equal(len_m, len_p)


def test_trained_predict_device_matches_jax(batch):
    ds, toks = batch
    jcfg, pcfg = jpred.PredictorConfig(**SMALL), ppred.PredictorConfig(**SMALL)
    np_params = _jax_params(SMALL, seed=3)
    feats = (ds.input_len.astype(np.float32), ds.price_in.astype(np.float32),
             ds.price_out.astype(np.float32))
    want = jpred.trained_predict_device(
        jcfg, jax.tree.map(jnp.asarray, np_params), jnp.asarray(toks),
        *map(jnp.asarray, feats))
    tp = ppred.TrainedPredictor(
        pcfg, convert.predictor_params_from_numpy(np_params, "cpu"),
        device="cpu")
    got = tp.predict_device(tp.device_inputs(), torch.from_numpy(toks),
                            *map(torch.from_numpy, feats))
    assert np.abs(got[0].numpy() - np.asarray(want[0])).max() < 1e-5
    assert np.allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5,
                       atol=1e-3)
    assert np.abs(got[2].numpy() - np.asarray(want[2])).max() < 1e-5
    assert set(tp.eval_accuracy(ds)) == {"capability_acc", "bucket_exact",
                                         "bucket_within1"}


def test_port_init_matches_declared_layout():
    """The port's own init: the JAX shapes, deterministic per seed."""
    pcfg = ppred.PredictorConfig(**SMALL)
    a = ppred.TrainedPredictor(pcfg, seed=1, device="cpu").params
    b = ppred.TrainedPredictor(pcfg, seed=1, device="cpu").params
    c = ppred.TrainedPredictor(pcfg, seed=2, device="cpu").params
    ref = _jax_params(SMALL)
    assert set(a) == set(ref) and len(a["layers"]) == len(ref["layers"])
    for k in ref:
        if k != "layers":
            assert tuple(a[k].shape) == ref[k].shape, k
            assert torch.equal(a[k], b[k])
    for la, lr in zip(a["layers"], ref["layers"]):
        assert {k: tuple(v.shape) for k, v in la.items()} == {
            k: v.shape for k, v in lr.items()}
    assert tuple(a["layers"][0]["wqkv"].shape) == (32, 3, 4, 8)
    assert not torch.equal(a["tok_embed"], c["tok_embed"])
    assert torch.all(a["layers"][0]["ln1"] == 1.0)


def test_hybrid_predict_device_matches_jax_with_shared_store(qaserve_splits):
    from repro.core.hybrid import HybridConfig as JH
    from repro.core.hybrid import hybrid_predict_device as jhybrid
    from repro.core.retrieval import RetrievalPredictor as JaxRP
    from repro_torch.core.features import projection
    from repro_torch.core.hybrid import hybrid_predict_device
    train, _, test = qaserve_splits
    hcfg = JH(d_retrieval=64, k=8)
    store = JaxRP(d=hcfg.d_retrieval, k=hcfg.k, seed=hcfg.feat_seed
                  ).fit(train).vstore
    vs = convert.vector_store_from_numpy(np.asarray(store.emb),
                                         np.asarray(store.labels),
                                         store.size, "cpu")
    np_params = _jax_params(SMALL, seed=5)
    jcfg, pcfg = jpred.PredictorConfig(**SMALL), ppred.PredictorConfig(**SMALL)
    toks = tokenizer.encode_batch(test.queries, 64)
    feats = (test.input_len.astype(np.float32),
             test.price_in.astype(np.float32),
             test.price_out.astype(np.float32))
    from repro.core.features import projection as jproj
    cap_j, len_j, cost_j, w_j = jhybrid(
        jax.tree.map(jnp.asarray, np_params), store.emb, store.labels,
        store.n_valid, jproj(hcfg.d_retrieval, hcfg.feat_seed),
        jnp.asarray(toks), *map(jnp.asarray, feats), pcfg=jcfg, k=hcfg.k,
        use_kernel=None, tau=hcfg.tau, temp=hcfg.temp)
    cap_p, len_p, cost_p, w_p = hybrid_predict_device(
        convert.predictor_params_from_numpy(np_params, "cpu"), vs.emb,
        vs.labels, vs.n_valid, projection(hcfg.d_retrieval, hcfg.feat_seed,
                                          "cpu"),
        torch.from_numpy(toks), *map(torch.from_numpy, feats), pcfg=pcfg,
        k=hcfg.k, tau=hcfg.tau, temp=hcfg.temp)
    assert np.abs(cap_p.numpy() - np.asarray(cap_j)).max() < 1e-5
    assert np.abs(cost_p.numpy() - np.asarray(cost_j)).max() < 1e-5
    assert np.abs(w_p.numpy() - np.asarray(w_j)).max() < 1e-5
    assert np.allclose(len_p.numpy(), np.asarray(len_j), rtol=1e-5, atol=1e-3)
    # the blend is live: some queries lean on each source
    assert w_p.min() < 0.5 < w_p.max()
