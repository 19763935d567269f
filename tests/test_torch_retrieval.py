"""The port's retrieval plane against the JAX package.

- ``retrieval_vote_ref`` (the vote kernel's plain version, the port's CPU
  path) against the NumPy oracle and the JAX Pallas kernel in interpret
  mode, on the reference's own cases: a store that is not a tile multiple,
  a padded query block, k > N_db, a dynamic ``n_valid`` and tie order on a
  duplicated store.  Tolerance 1e-5 on similarities and votes (float32 dot
  products summed in another order; the labels are in [0, 1)); indices
  exact, in order.
- ``topk_retrieval_ref`` (the top-k kernel's plain version, the CPU path
  of ``ops.topk_retrieval``) against the JAX ``topk_retrieval_kernel`` in
  interpret mode and the JAX ``topk_retrieval_ref`` on the reference's four
  crash cases (1e-5 on similarities; sorted index rows equal on >= 0.999,
  the reference's own contract; ``(NEG_INF, -1)`` past N_db), exact index
  order on a duplicated store, exact indices with ``n_valid``; its
  ``(vals, idx)`` equal to ``retrieval_vote_ref``'s exactly; ``cosine_topk``
  against the JAX ``cosine_topk`` (1e-5, indices exact).
- ``featurize_tokens`` (``embedding_bag``) against the JAX gather-sum and
  the host oracle: 1e-5 (float32 sums in another order).
- ``VectorStore`` growth, and ``RetrievalPredictor.predict_arrays`` over
  the same store: capability within 1e-5; expected length and cost within
  1e-5 relative (lengths reach 1024, where a float32 ulp is 6e-5).
- The CUDA kernel's two design arguments, which hold here where it cannot
  run: its 3xTF32 product (a NumPy emulation: operands split into
  round-to-nearest TF32 hi and lo, lo*hi' + hi*lo' + hi*hi' summed in
  float32) lies within 1e-6 of the float64 product on unit d-256 vectors,
  where one TF32 pass misses the 1e-5 contract, and gives bit-equal
  similarities for duplicated rows; and the per-slice top-k lists, merged
  in slice order by the same fold, are ``topk_retrieval_ref``'s
  ``(vals, idx)`` exactly.  The wrapper's slice count fills the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.topk_retrieval.kernel import (  # noqa: E402
    retrieval_vote_kernel, topk_retrieval_kernel)
from repro.kernels.topk_retrieval.ref import (  # noqa: E402
    retrieval_vote_oracle, topk_retrieval_ref as jax_topk_ref)
from repro_torch.kernels.topk_retrieval import ops as port_ops  # noqa: E402
from repro_torch.kernels.topk_retrieval.ref import (  # noqa: E402
    NEG_INF, retrieval_vote_ref, topk_retrieval_ref)


def _unit_rows(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _port(store, labels, queries, k, n_valid=None):
    out = port_ops.retrieval_vote(torch.from_numpy(store),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(queries), k, n_valid)
    return tuple(t.numpy() for t in out)


# (ndb, d, b, k, tile, bq, n_labels, n_valid); the JAX kernel runs in
# interpret mode only where ndb <= 256
CASES = [
    (700, 64, 17, 8, 512, 64, 12, None),   # store not a tile multiple
    (200, 32, 37, 8, 64, 16, 12, None),    # ... in interpret mode, padded q
    (130, 32, 33, 16, 64, 32, 6, None),    # padded query block
    (5, 32, 4, 8, 128, 64, 12, None),      # k > N_db: vote over 5 only
    (256, 16, 9, 8, 64, 8, 4, 100),        # dynamic n_valid
    (128, 16, 6, 8, 32, 8, 4, 50),         # dynamic n_valid, tile multiple
]


@pytest.mark.parametrize("ndb,d,b,k,tile,bq,nl,nv", CASES)
def test_vote_ref_matches_oracle_and_jax_kernel(ndb, d, b, k, tile, bq, nl,
                                                nv):
    rng = np.random.RandomState(ndb + b)
    st = _unit_rows(rng, (ndb, d))
    q = _unit_rows(rng, (b, d))
    lab = rng.rand(ndb, nl).astype(np.float32)
    pv, pi, pvote = _port(st, lab, q, k, nv)
    ov, oi, ovote = retrieval_vote_oracle(st, lab, q, k, n_valid=nv)
    assert pv.shape == (b, k) and pi.dtype == np.int32
    assert np.array_equal(pi, oi)
    assert np.abs(pv - ov).max() < 1e-5
    assert np.abs(pvote - ovote).max() < 1e-5
    if ndb <= 256:
        kv, ki, kvote = retrieval_vote_kernel(st, lab, q, k, bq=bq, tile=tile,
                                              interpret=True, n_valid=nv)
        assert np.array_equal(pi, np.asarray(ki))
        assert np.abs(pv - np.asarray(kv)).max() < 1e-5
        assert np.abs(pvote - np.asarray(kvote)).max() < 1e-5
    n_live = ndb if nv is None else nv
    if k > n_live:                     # empty slots: (NEG_INF, -1)
        assert np.all(pi[:, n_live:] == -1)
        assert np.all(pv[:, n_live:] <= NEG_INF * 0.5)


def test_vote_tie_order_on_duplicated_store():
    """Every store row twice: ties go to the lower db index, in order."""
    rng = np.random.RandomState(2)
    base = _unit_rows(rng, (8, 16))
    st = np.concatenate([base, base])
    q = _unit_rows(rng, (5, 16))
    lab = rng.rand(16, 3).astype(np.float32)
    pv, pi, pvote = _port(st, lab, q, 6)
    kv, ki, kvote = retrieval_vote_kernel(st, lab, q, 6, bq=8, tile=8,
                                          interpret=True)
    assert np.array_equal(pi, np.asarray(ki))
    assert np.array_equal(pi, retrieval_vote_oracle(st, lab, q, 6)[1])
    assert np.abs(pv - np.asarray(kv)).max() < 1e-6
    # the two copies of a neighbour sit side by side, lower index first
    assert np.all(pi[:, 0] + 8 == pi[:, 1])


def test_vote_excludes_empty_slots():
    rng = np.random.RandomState(4)
    st = _unit_rows(rng, (3, 16))
    lab = np.asarray([[10.0], [20.0], [30.0]], np.float32)
    _, idx, vote = _port(st, lab, st[:1], 8)
    assert np.all(idx[0, 3:] == -1)
    assert abs(float(vote[0, 0]) - 20.0) < 1e-5       # mean of all 3, not 8


def test_vote_dispatch_rejects_other_devices():
    st = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError):
        port_ops.retrieval_vote(st, torch.zeros((4, 2), device="meta"), st, 2)


def _port_topk(store, queries, k, n_valid=None):
    vals, idx = port_ops.topk_retrieval(torch.from_numpy(store),
                                        torch.from_numpy(queries), k, n_valid)
    return vals.numpy(), idx.numpy()


@pytest.mark.parametrize("ndb,d,b,k,tile,bq", [
    (700, 64, 17, 8, 512, 64),     # store not a tile multiple
    (900, 32, 33, 4, 256, 32),     # non-multiple store + padded query block
    (5, 32, 4, 8, 128, 64),        # k > n_db
    (128, 16, 3, 128, 64, 64),     # k == n_db across tiles
])
def test_topk_crash_cases_match_jax(ndb, d, b, k, tile, bq):
    rng = np.random.RandomState(ndb + k)
    st = _unit_rows(rng, (ndb, d))
    q = _unit_rows(rng, (b, d))
    pv, pi = _port_topk(st, q, k)
    assert pv.shape == (b, k) and pi.shape == (b, k) and pi.dtype == np.int32
    refs = [jax_topk_ref(st, q, k)]
    # k = 128 is past the card's k <= 64, so only the plain version takes
    # it; the JAX kernel's fold over 128 slots takes ~8 s in interpret mode,
    # and tests/test_prediction_plane.py holds it to the jnp ref there
    if k <= 64:
        refs.append(topk_retrieval_kernel(st, q, k, bq=bq, tile=tile,
                                          interpret=True))
    for v, i in refs:
        assert np.abs(pv - np.asarray(v)).max() < 1e-5
        assert (np.sort(pi, 1) == np.sort(np.asarray(i), 1)).mean() > 0.999
    if k > ndb:                        # empty slots: (NEG_INF, -1)
        assert np.all(pi[:, ndb:] == -1)
        assert np.all(pv[:, ndb:] <= NEG_INF * 0.5)


def test_topk_tie_order_on_duplicated_store():
    """Every store row twice: exact order, lower db index first, as the
    JAX kernel and ``jax.lax.top_k`` give it."""
    rng = np.random.RandomState(6)
    base = _unit_rows(rng, (8, 16))
    st = np.concatenate([base, base])
    q = _unit_rows(rng, (5, 16))
    pv, pi = _port_topk(st, q, 6)
    kv, ki = topk_retrieval_kernel(st, q, 6, bq=8, tile=8, interpret=True)
    assert np.array_equal(pi, np.asarray(ki))
    assert np.array_equal(pi, np.asarray(jax_topk_ref(st, q, 6)[1]))
    assert np.abs(pv - np.asarray(kv)).max() < 1e-6
    assert np.all(pi[:, 0] + 8 == pi[:, 1])


def test_topk_dynamic_n_valid():
    """n_valid = 100 of 256 rows: the same neighbours as a 100-row store."""
    rng = np.random.RandomState(3)
    st = _unit_rows(rng, (256, 32))
    q = _unit_rows(rng, (9, 32))
    pv, pi = _port_topk(st, q, 4, n_valid=100)
    kv, ki = topk_retrieval_kernel(st, q, 4, bq=8, tile=64, interpret=True,
                                   n_valid=100)
    assert np.array_equal(pi, np.asarray(ki))
    assert np.array_equal(pi, np.asarray(jax_topk_ref(st[:100], q, 4)[1]))
    assert np.abs(pv - np.asarray(kv)).max() < 1e-6
    assert pi.max() < 100


@pytest.mark.parametrize("ndb,d,b,k,tile,bq,nl,nv", CASES)
def test_topk_ref_equals_vote_ref(ndb, d, b, k, tile, bq, nl, nv):
    """The vote's plain version is the top-k's plus the label mean: the
    same (vals, idx), exactly."""
    rng = np.random.RandomState(ndb + b)
    st, q = torch.from_numpy(_unit_rows(rng, (ndb, d))), torch.from_numpy(
        _unit_rows(rng, (b, d)))
    lab = torch.rand(ndb, nl, generator=torch.Generator().manual_seed(ndb))
    tv, ti = topk_retrieval_ref(st, q, k, nv)
    vv, vi, _ = retrieval_vote_ref(st, lab, q, k, nv)
    assert torch.equal(tv, vv) and torch.equal(ti, vi)


@pytest.mark.parametrize("ndb,k", [(300, 8), (6, 10)])
def test_cosine_topk_matches_jax(ndb, k):
    from repro.core.retrieval import cosine_topk as jax_cosine_topk
    from repro_torch.core import cosine_topk
    rng = np.random.RandomState(ndb)
    st, q = _unit_rows(rng, (ndb, 32)), _unit_rows(rng, (11, 32))
    vals, idx = cosine_topk(torch.from_numpy(st), torch.from_numpy(q), k)
    jv, ji = jax_cosine_topk(st, q, k)
    assert vals.shape == (11, k)
    assert np.abs(vals.numpy() - np.asarray(jv)).max() < 1e-5
    assert np.array_equal(idx.numpy(), np.asarray(ji))
    if k > ndb:
        assert np.all(idx.numpy()[:, ndb:] == -1)


def test_topk_dispatch_by_device():
    """A CPU tensor runs the plain version and launches nothing; a device
    without a kernel raises; the CUDA wrapper refuses CPU tensors."""
    from repro_torch.kernels.topk_retrieval.kernel import topk_retrieval_cuda
    rng = np.random.RandomState(1)
    st, q = _unit_rows(rng, (40, 8)), _unit_rows(rng, (3, 8))
    before = port_ops.topk_launches
    pv, pi = _port_topk(st, q, 5)
    assert port_ops.topk_launches == before
    rv, ri = topk_retrieval_ref(torch.from_numpy(st), torch.from_numpy(q), 5)
    assert np.array_equal(pv, rv.numpy()) and np.array_equal(pi, ri.numpy())
    meta = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError):
        port_ops.topk_retrieval(meta, meta, 2)
    with pytest.raises(ValueError):
        topk_retrieval_cuda(torch.from_numpy(st), torch.from_numpy(q), 5)


@pytest.mark.parametrize("d,seed", [(128, 3), (256, 7)])
def test_featurize_tokens_matches_jax(qaserve_splits, d, seed):
    import jax.numpy as jnp
    from repro.core.features import featurize
    from repro.core.features import featurize_tokens as jax_featurize
    from repro.core.features import projection as jax_projection
    from repro_torch.core.features import featurize_tokens, projection
    from repro_torch.data import tokenizer
    train, _, _ = qaserve_splits
    toks = tokenizer.encode_batch(train.queries[:64] + [""], 64)
    got = featurize_tokens(torch.from_numpy(toks),
                           projection(d, seed, "cpu")).numpy()
    want = np.asarray(jax_featurize(jnp.asarray(toks),
                                    jax_projection(d, seed)))
    assert np.abs(got - want).max() < 1e-5
    assert np.abs(got - featurize(train.queries[:64] + [""], d, seed)
                  ).max() < 1e-5
    assert np.allclose(np.linalg.norm(got[:-1], axis=1), 1.0, atol=1e-5)
    assert np.all(got[-1] == 0.0)                    # no tokens -> zero row


def test_vector_store_growth_matches_jax():
    from repro.core.retrieval import VectorStore as JaxStore
    from repro_torch.core.retrieval import VectorStore
    port, ref = VectorStore(8, 2, capacity=8, device="cpu"), JaxStore(8, 2,
                                                                      capacity=8)
    rng = np.random.RandomState(0)
    for n in (7, 7, 7, 7, 7, 200):
        emb, lab = rng.randn(n, 8).astype(np.float32), rng.rand(n, 2)
        port.append(emb, lab)
        ref.append(emb, lab)
        assert port.size == ref.size and port.capacity == ref.capacity
        if port.size == 35:
            port.compact()
            ref.compact()
            assert port.capacity == ref.capacity == 128
    assert port.n_valid == int(ref.n_valid) == 235
    assert np.array_equal(port.emb.numpy(), np.asarray(ref.emb))
    assert np.allclose(port.labels.numpy(), np.asarray(ref.labels))


@pytest.mark.parametrize("k", [1, 8])
def test_retrieval_predictor_matches_jax(qaserve_splits, k):
    from repro.core.retrieval import RetrievalPredictor as JaxRP
    from repro_torch.convert import vector_store_from_numpy
    from repro_torch.core.retrieval import RetrievalPredictor
    train, _, test = qaserve_splits
    ref = JaxRP(k=k).fit(train)
    port = RetrievalPredictor(k=k, device="cpu").fit(train)
    assert port.vstore.size == ref.vstore.size
    assert np.abs(port.vstore.emb.numpy() - np.asarray(ref.vstore.emb)
                  ).max() < 1e-5
    # the JAX store carried across, and the port's own store
    carried = RetrievalPredictor(k=k, device="cpu")
    carried.vstore = vector_store_from_numpy(
        np.asarray(ref.vstore.emb), np.asarray(ref.vstore.labels),
        ref.vstore.size, "cpu")
    want = ref.predict_arrays(test)
    for pred in (port, carried):
        cap, exp_len, cost = pred.predict_arrays(test)
        assert np.abs(cap - want[0]).max() < 1e-5
        assert np.allclose(exp_len, want[1], rtol=1e-5, atol=1e-5)
        assert np.allclose(cost, want[2], rtol=1e-5, atol=1e-9)
    acc = port.eval_accuracy(test)
    assert acc == pytest.approx(ref.eval_accuracy(test), abs=1e-9)


def _tf32_rna(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero: the kernel's ``tf32_rna`` (cvt.rna.tf32.f32)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _sims_tf32(q, s, passes=3):
    """The kernel's product, emulated: per k-step of 8, lo*hi', hi*lo',
    hi*hi' (or hi*hi' alone, passes=1) added to a float32 sum.  Products
    of two TF32 values are exact in float32."""
    qh, sh = _tf32_rna(q), _tf32_rna(s)
    ql, sl = _tf32_rna(q - qh), _tf32_rna(s - sh)
    terms = ((ql, sh), (qh, sl), (qh, sh)) if passes == 3 else ((qh, sh),)
    acc = np.zeros((q.shape[0], s.shape[0]), np.float32)
    for k0 in range(0, q.shape[1], 8):
        for a, b in terms:
            for kk in range(k0, k0 + 8):
                acc = acc + a[:, kk, None] * b[None, :, kk]
    return acc


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_product_keeps_the_fp32_contract(seed):
    """hi + lo holds x to 2**-22; the three-pass product stays within 1e-6
    of the float64 product (one TF32 pass does not stay within 1e-5); and
    identical store rows give bit-equal similarities."""
    rng = np.random.RandomState(seed)
    q, base = _unit_rows(rng, (48, 256)), _unit_rows(rng, (384, 256))
    hi = _tf32_rna(q)
    lo = _tf32_rna(q - hi)
    resid = np.abs(q.astype(np.float64) - hi - lo)
    assert np.all(resid <= 2.0 ** -22 * np.abs(q))
    assert np.all(_tf32_rna(hi) == hi) and np.all(_tf32_rna(lo) == lo)
    store = np.concatenate([base, base])
    sims = _sims_tf32(q, store)
    exact = q.astype(np.float64) @ store.astype(np.float64).T
    assert np.abs(sims - exact).max() <= 1e-6
    assert np.abs(_sims_tf32(q, base, passes=1) - exact[:, :384]).max() > 1e-5
    assert sims[:, :384].tobytes() == sims[:, 384:].tobytes()


def _fold(vals, idx, cand_v, cand_i, k):
    """The kernel's fold: candidates in order; one enters only if strictly
    above the k-th value and lands after every equal entry."""
    for v, i in zip(cand_v, cand_i):
        if v > vals[k - 1]:
            pos = int(np.sum(vals >= v))
            vals = np.insert(vals, pos, v)[:k]
            idx = np.insert(idx, pos, i)[:k]
    return vals, idx


def _sliced_topk(sims, k, n_slices, tile=128):
    """Per-slice lists over runs of whole tiles (the kernel's split), then
    the last CTA's merge: the lists folded in slice order."""
    n_rows = sims.shape[1]
    n_tiles = -(-n_rows // tile)
    out_v = np.full((sims.shape[0], k), NEG_INF, np.float32)
    out_i = np.full((sims.shape[0], k), -1, np.int32)
    for q in range(sims.shape[0]):
        mv, mi = out_v[q], out_i[q]
        for s in range(n_slices):
            lo = n_tiles * s // n_slices * tile
            hi = min(n_tiles * (s + 1) // n_slices * tile, n_rows)
            sv, si = _fold(np.full(k, NEG_INF, np.float32),
                           np.full(k, -1, np.int32), sims[q, lo:hi],
                           np.arange(lo, hi, dtype=np.int32), k)
            mv, mi = _fold(mv, mi, sv, si, k)
        out_v[q], out_i[q] = mv, mi
    return out_v, out_i


@pytest.mark.parametrize("case", ["n_valid in a slice", "k > n_valid",
                                  "duplicated store"])
def test_slice_merge_equals_the_plain_topk(case):
    rng = np.random.RandomState(11)
    q = _unit_rows(rng, (9, 32))
    if case == "n_valid in a slice":
        store, k, nv, n_slices = _unit_rows(rng, (700, 32)), 8, 300, 3
    elif case == "k > n_valid":
        store, k, nv, n_slices = _unit_rows(rng, (10, 32)), 16, 10, 1
    else:   # rows i and i + 301 tie exactly; 301 is no tile multiple
        base = _unit_rows(rng, (301, 32))
        store, k, nv, n_slices = np.concatenate([base, base]), 16, 602, 4
    st, qt = torch.from_numpy(store), torch.from_numpy(q)
    want_v, want_i = topk_retrieval_ref(st, qt, k, nv)
    sims = (qt @ st[:nv].T).numpy()        # the plain version's product
    got_v, got_i = _sliced_topk(sims, k, n_slices)
    assert np.array_equal(got_v, want_v.numpy())
    assert np.array_equal(got_i, want_i.numpy())
    if case == "duplicated store":
        assert np.all(got_i[:, 0] + 301 == got_i[:, 1])


def test_slices_fill_the_card():
    """The grid covers all 132 SMs at the route batch and the stream
    window, fills its waves to FILL, and keeps MIN_SLICE_TILES tiles a
    slice; a store of one tile gets one slice."""
    from repro_torch.kernels.topk_retrieval.kernel import (
        BQ, FILL, MIN_SLICE_TILES, TN, slices)
    for b in (16_384, 4_096, 1_024, 512):
        s = slices(b, 131_072, 132)
        ctas = -(-b // BQ) * s
        assert ctas >= 132 and ctas / (132 * -(-ctas // 132)) >= FILL
        assert 131_072 // TN // s >= MIN_SLICE_TILES
    assert (slices(16_384, 131_072, 132), slices(4_096, 131_072, 132)) == (
        2, 8)
    assert slices(4_096, 700, 132) == 1 and slices(0, 131_072, 132) == 1
