"""The port's paged serving plane against the JAX package.

- ``PageAllocator``: the invariants of the reference's own test (unique
  pages, never the dump page, no double allocation, exhaustion errors that
  leave the free lists untouched, reuse after release).
- ``Endpoint`` under churn (requests admitted as slots free up), run in
  lockstep with the JAX ``Endpoint`` on the same float32 parameters: the
  same greedy tokens per request, the allocator drained back to full,
  zeroed block table, no batch re-prefill.
- ``MultiLLMServer`` over two float32 smoke endpoints behind
  ``BalanceAware`` with ``null_route_features``: the same (endpoint,
  output) per request id as the JAX server, one-shot and streaming; with
  requests arriving over the decode clock, routing windows rate-limited by
  ``window_steps`` and resized by ``AdaptiveWindow``, the same (endpoint,
  output, admission step) per request and the same window trajectory.
- ``AdaptiveWindow`` updates as the JAX one does.
- The port's ``OmniRouter`` in front (``stream=False``) serves every
  request.  With ``stream=True`` over the port's and the JAX
  ``OmniRouter`` (the same fixed predictions per request, so the predictor
  is not under test here), requests arriving over the decode clock and
  ``window_steps`` 2, every window padded to a power-of-two bucket and
  masked by ``n_valid``: the same (endpoint, output, admission step) per
  request, the same window count and dual iterations — with and without a
  speculative pair column, and in budget mode with a stream ``horizon``.
  (The failure plane: ``tests/test_torch_serving_faults.py``.)
- ``RestartEndpoint`` (the restart-batching baseline over the dense-cache
  ``decode_step``) under churn with ragged prompts (left pads), in lockstep
  with the JAX ``RestartEndpoint`` on the same float32 parameters: the same
  completions every step, the same outputs, ``batch_reprefills`` and
  ``prefill_calls``.  Behind ``MultiLLMServer`` over two smoke configs, the
  paged and the restart endpoints give the same (endpoint, output) per
  request (equal prompt lengths, float32, so the left pads are inert),
  with no batch re-prefill on the paged side and some on the restart side,
  over (h2o-danube-3-4b, gemma3-4b) and over the reference's own
  (h2o-danube-3-4b, hymba-1.5b) pool (``tests/test_serving_paged.py``'s
  ``test_server_paged_matches_restart_engine``).
- The reference's six-model pool (``launch/serve.py``: h2o-danube-3-4b,
  internlm2-20b, qwen2-72b, gemma3-4b, hymba-1.5b, xlstm-350m) at smoke
  size in float32 behind ``BalanceAware``, in lockstep with the JAX server:
  the same (endpoint, output) per request, every endpoint serving, no
  batch re-prefill; a recurrent endpoint refused as a speculative column
  by both servers.

Greedy tokens are compared exactly: the logits agree to ~1e-5 (see
``tests/test_torch_models.py``), far inside these models' top-2 gaps.
The one uncast float32 endpoint (C16) runs bf16 activations, whose
roundings differ between the packages: there a differing token must be a
near tie of the reference's logits.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.baselines import BalanceAware as JaxBA  # noqa: E402
from repro.core import OmniRouter as JaxRouter  # noqa: E402
from repro.core import RouterConfig as JaxRCfg  # noqa: E402
from repro.core import SpecPair as JaxPair  # noqa: E402
from repro.core.baselines import RouteBatch as JaxBatch  # noqa: E402
from repro.core.control import AdaptiveWindow as JaxAW  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import (BalanceAware, HybridPredictor,  # noqa: E402
                              OmniRouter, PredictorConfig, RouteBatch,
                              RouterConfig)
from repro_torch.core.speculative import SpecPair  # noqa: E402
from repro_torch.core.control import AdaptiveWindow  # noqa: E402
from repro_torch.data.qaserve import DEFAULT_POOL, generate  # noqa: E402
from repro_torch.data.tokenizer import encode_for_config  # noqa: E402
from repro_torch.serving.engine import (Endpoint, MultiLLMServer,  # noqa: E402
                                        PageAllocator, Request,
                                        RestartEndpoint, null_route_features)

ARCHS = ("h2o-danube-3-4b", "qwen2-72b")
EP = dict(max_concurrency=3, t_max=64, page_size=8, sync_every=4)


def _endpoints(seeds=(0, 1), arches=ARCHS):
    """(JAX endpoints, port endpoints) on the same float32 parameters."""
    jeps, peps = [], []
    for arch, seed in zip(arches, seeds):
        jc = dataclasses.replace(jax_smoke(arch), dtype=jnp.float32)
        pc = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
        je = jax_engine.Endpoint(jc, seed=seed, **EP)
        je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
        params = convert.model_params_from_numpy(
            pc, jax.tree.map(np.asarray, je.params), "cpu")
        jeps.append(je)
        peps.append(Endpoint(pc, params=params, device="cpu", **EP))
    return jeps, peps


def _requests(n, seed=0, vocab=512):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, vocab, (int(rng.randint(2, 20)),)).astype(
        np.int32), int(rng.randint(3, 12))) for _ in range(n)]


def _drained(ep):
    return (len(ep.alloc.free_pages) == ep.alloc.n_pages - 1
            and sorted(ep.alloc.free_slots) == list(range(ep.L))
            and not ep.block_table.any() and ep.active_count() == 0)


def test_page_allocator_invariants():
    a = PageAllocator(n_pages=9, n_slots=3)
    got = a.alloc_pages(5)
    assert len(set(got)) == 5 and 0 not in got          # unique, no dump page
    more = a.alloc_pages(3)
    assert not (set(got) & set(more))                   # no double allocation
    with pytest.raises(RuntimeError):
        a.alloc_pages(1)                                # pool exhausted
    a.release_pages(got)
    with pytest.raises(RuntimeError):
        a.release_pages(got[:1])                        # double free
    again = a.alloc_pages(5)
    assert set(again) == set(got)                       # freed pages reused
    s = [a.alloc_slot() for _ in range(3)]
    assert sorted(s) == [0, 1, 2]
    with pytest.raises(RuntimeError, match="slot pool exhausted"):
        a.alloc_slot()
    a.release_slot(s[0])
    assert a.alloc_slot() == s[0]
    # a failing alloc_pages leaves NO partial pops behind
    free_before = list(a.free_pages)
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        a.alloc_pages(len(free_before) + 1)
    assert a.free_pages == free_before
    with pytest.raises(RuntimeError):
        a.release_pages([0])                            # the dump page


def test_endpoint_churn_matches_jax_and_drains():
    jeps, peps = _endpoints()
    je, pe = jeps[0], peps[0]
    todo = _requests(8, seed=1)
    jreqs = [jax_engine.Request(i, t, max_new=m) for i, (t, m) in
             enumerate(todo)]
    preqs = [Request(i, t, max_new=m) for i, (t, m) in enumerate(todo)]
    nxt = 0
    while nxt < len(todo) or pe.active_count():
        while nxt < len(todo) and pe.has_capacity():
            assert je.admit(jreqs[nxt]) == pe.admit(preqs[nxt])
            nxt += 1
        assert [r.rid for r in je.step()] == [r.rid for r in pe.step()]
        assert np.array_equal(je.block_table, pe.block_table)
        assert np.array_equal(je.lens, pe.lens)
    for jr, pr in zip(jreqs, preqs):
        assert pr.done and len(pr.output) == pr.max_new
        assert pr.output == jr.output
    assert len(pe.alloc.free_pages) == pe.alloc.n_pages - 1
    assert sorted(pe.alloc.free_slots) == list(range(pe.L))
    assert not pe.block_table.any() and pe.active_count() == 0
    assert pe.batch_reprefills == 0 and pe.prefill_calls == len(todo)
    assert pe.decoded_tokens == sum(m for _, m in todo)


# C16: a logit a few bf16 ulps (2**-8 relative each) below the top counts
# as a tie the two packages' bf16 roundings may break either way
NEAR_TIE = 2.0 ** -5


def test_uncast_float32_endpoint_serves_as_jax():
    """C16: a float32 configuration on its own (bf16) init, as the
    reference runs it: bf16 activations against float32 KV pools (the
    decode entries promote the bf16 queries to the pools' float32 before
    the kernel's one-dtype contract, as JAX promotes them).  The port's
    endpoint serves the smoke requests in lockstep with the JAX endpoint:
    the same admissions and completions every step, and the same greedy
    tokens, but where the packages' bf16 roundings break a near tie: at a
    request's first differing token the port's choice lies within
    ``NEAR_TIE`` of the top of the reference's own logits (its dense
    prefill of the shared prefix, float32 readout), and the tokens before
    it are equal."""
    from repro.models import build_model as jax_build
    arch = ARCHS[0]
    jc = dataclasses.replace(jax_smoke(arch), dtype=jnp.float32)
    pc = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    je = jax_engine.Endpoint(jc, seed=0, **EP)
    assert {str(a.dtype) for a in jax.tree.leaves(je.params)} == {"bfloat16"}
    params = convert.model_params_from_numpy(
        get_smoke_config(arch),
        jax.tree.map(lambda a: np.asarray(a, np.float32), je.params), "cpu")
    pe = Endpoint(pc, params=params, device="cpu", **EP)
    pools = [t for t in jax.tree.leaves(pe._state)
             if isinstance(t, torch.Tensor) and t.is_floating_point()]
    assert pools and all(t.dtype == torch.float32 for t in pools)
    todo = _requests(8, seed=1)
    jreqs = [jax_engine.Request(i, t, max_new=m) for i, (t, m) in
             enumerate(todo)]
    preqs = [Request(i, t, max_new=m) for i, (t, m) in enumerate(todo)]
    nxt = 0
    while nxt < len(todo) or pe.active_count():
        while nxt < len(todo) and pe.has_capacity():
            assert je.admit(jreqs[nxt]) == pe.admit(preqs[nxt])
            nxt += 1
        assert [r.rid for r in je.step()] == [r.rid for r in pe.step()]
    jm = jax_build(jc)
    for (prompt, _), jr, pr in zip(todo, jreqs, preqs):
        assert pr.done and len(pr.output) == len(jr.output) == pr.max_new
        diff = [i for i, (a, b) in enumerate(zip(jr.output, pr.output))
                if a != b]
        if not diff:
            continue
        i = diff[0]
        seq = np.concatenate([prompt, np.asarray(jr.output[:i], np.int32)])
        _, logits = jm.prefill(je.params, jnp.asarray(seq[None]))
        logits = np.asarray(logits, np.float32)[0]
        gap = logits.max() - logits[pr.output[i]]
        assert gap <= NEAR_TIE * np.abs(logits).max(), (jr.rid, i, gap)
    assert len(pe.alloc.free_pages) == pe.alloc.n_pages - 1
    assert sorted(pe.alloc.free_slots) == list(range(pe.L))
    assert not pe.block_table.any() and pe.batch_reprefills == 0


def _serve_outputs(ep, make, todo):
    reqs = [make(i, t, max_new=m) for i, (t, m) in enumerate(todo)]
    nxt = 0
    while nxt < len(todo) or ep.active_count():
        while nxt < len(todo) and ep.has_capacity():
            ep.admit(reqs[nxt])
            nxt += 1
        ep.step()
    return [list(r.output) for r in reqs]


def test_uncast_float32_endpoint_serves_as_the_bf16_configuration():
    """C16's second witness: the uncast float32 endpoint runs bf16
    activations and keeps bf16 keys and values in float32 pools, so in
    each package it gives the bf16 configuration's greedy tokens exactly.
    Whatever separates the port's tokens from JAX's in the float32
    configuration (the near ties above) separates them in the bf16
    configuration too, which takes no promotion branch: the same requests
    differ, at the same steps.  (The promotion itself is held at the op,
    where the pools hold values bf16 cannot: ``tests/
    test_torch_decode_attention.py``'s mixed-dtype cases.)"""
    arch = ARCHS[0]
    todo = _requests(8, seed=1)
    out = {}
    for f32 in (True, False):
        jc, pc = jax_smoke(arch), get_smoke_config(arch)
        if f32:
            jc = dataclasses.replace(jc, dtype=jnp.float32)
            pc = dataclasses.replace(pc, dtype=torch.float32)
        je = jax_engine.Endpoint(jc, seed=0, **EP)
        params = convert.model_params_from_numpy(
            get_smoke_config(arch),
            jax.tree.map(lambda a: np.asarray(a, np.float32), je.params),
            "cpu")
        pe = Endpoint(pc, params=params, device="cpu", **EP)
        pools = {t.dtype for t in jax.tree.leaves(pe._state)
                 if isinstance(t, torch.Tensor) and t.is_floating_point()}
        assert pools == {torch.float32 if f32 else torch.bfloat16}
        out[("jax", f32)] = _serve_outputs(je, jax_engine.Request, todo)
        out[("port", f32)] = _serve_outputs(pe, Request, todo)
    for pkg in ("jax", "port"):
        assert out[(pkg, True)] == out[(pkg, False)], pkg

    def first_diffs(a, b):
        return [next((i for i, (x, y) in enumerate(zip(p, q)) if x != y),
                     None) for p, q in zip(a, b)]

    assert (first_diffs(out[("jax", True)], out[("port", True)])
            == first_diffs(out[("jax", False)], out[("port", False)]))


def test_endpoint_cancel_frees_the_slot_and_pages():
    _, (pe, _) = _endpoints()
    r = Request(0, np.arange(1, 12, dtype=np.int32), max_new=9)
    pe.admit(r)
    pe.step()
    assert pe.cancel(r) and not pe.cancel(r)
    assert len(pe.alloc.free_pages) == pe.alloc.n_pages - 1
    assert sorted(pe.alloc.free_slots) == list(range(pe.L))
    assert not pe.block_table.any() and len(r.output) == pe.sync_every


@pytest.mark.parametrize("stream", [False, True])
def test_server_matches_jax_balance_aware(stream):
    jeps, peps = _endpoints()
    js = jax_engine.MultiLLMServer(jeps, JaxBA(), stream=stream)
    ps = MultiLLMServer(peps, BalanceAware(), stream=stream)
    too_long = np.ones(80, np.int32)           # fits no endpoint: failed
    for rid, (toks, m) in enumerate(_requests(12, seed=2) + [(too_long, 4)]):
        js.submit(jax_engine.Request(rid, toks, max_new=m))
        ps.submit(Request(rid, toks, max_new=m))
    want = {r.rid: (r.endpoint, list(r.output))
            for r in js.run(jax_engine.null_route_features)}
    got = {r.rid: (r.endpoint, list(r.output))
           for r in ps.run(null_route_features)}
    assert got == want and len(got) == 13
    assert got[12] == (-1, [])
    assert ps.windows == js.windows and ps.route_calls == js.route_calls
    assert all(_drained(e) and e.batch_reprefills == 0 for e in peps)


def _counting(base):
    """A ``base`` (BalanceAware) policy reporting a dual-iteration count
    that grows by a fixed cycle per routed window, so an AdaptiveWindow
    both widens (a solve past its target) and narrows (a cheap solve with a
    deep backlog)."""
    class Counting(base):
        def __init__(self):
            self.dual_iters = 0
            self._cost = itertools.cycle((90, 0, 0, 120, 3))

        def route(self, batch, rng=None):
            self.dual_iters += next(self._cost)
            return super().route(batch, rng=rng)

    return Counting()


@pytest.mark.parametrize("window,adaptive", [(2.0, False), (3.0, True)])
def test_server_windows_match_jax(window, adaptive):
    jeps, peps = _endpoints()
    jaw, paw = ((cls(window, lo=1.0, hi=8.0, target_iters=50, deep_queue=2)
                 if adaptive else None) for cls in (JaxAW, AdaptiveWindow))
    js = jax_engine.MultiLLMServer(jeps, _counting(JaxBA),
                                   window_steps=window, adapt_window=jaw)
    ps = MultiLLMServer(peps, _counting(BalanceAware), window_steps=window,
                        adapt_window=paw)
    rng = np.random.RandomState(4)
    arrive = np.round(np.cumsum(rng.exponential(0.5, 16)), 2)
    for rid, ((toks, m), at) in enumerate(zip(_requests(16, seed=3), arrive)):
        js.submit(jax_engine.Request(rid, toks, max_new=m), at_step=at)
        ps.submit(Request(rid, toks, max_new=m), at_step=at)
    want = {r.rid: (r.endpoint, list(r.output), r.admit_step)
            for r in js.run(jax_engine.null_route_features)}
    got = {r.rid: (r.endpoint, list(r.output), r.admit_step)
           for r in ps.run(null_route_features)}
    assert got == want and len(got) == 16
    assert ps.windows == js.windows and ps.dual_iters == js.dual_iters
    if adaptive:
        assert (paw.window, paw.widened, paw.narrowed) == (
            jaw.window, jaw.widened, jaw.narrowed)
        assert paw.widened > 0 and paw.narrowed > 0
    assert all(_drained(e) and e.batch_reprefills == 0 for e in peps)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_window_copy_updates_the_same(seed):
    rng = np.random.RandomState(seed)
    got, want = (cls(4.0, lo=1.0, hi=16.0, target_iters=40, deep_queue=8)
                 for cls in (AdaptiveWindow, JaxAW))
    for _ in range(60):
        iters, depth = int(rng.randint(0, 100)), int(rng.randint(0, 30))
        assert got.update(iters, depth) == want.update(iters, depth)
    assert (got.widened, got.narrowed) == (want.widened, want.narrowed)
    for bad in (dict(window=0.5), dict(window=4.0, grow=0.9)):
        with pytest.raises(ValueError):
            AdaptiveWindow(lo=1.0, hi=16.0, **bad)


def _router_pool():
    pool = DEFAULT_POOL[:2]
    store = generate(n=600, seed=0, pool=pool)
    hp = HybridPredictor(PredictorConfig(n_models=2), seed=0,
                         device="cpu").fit_store(store)
    return OmniRouter(hp, RouterConfig(alpha=0.75)), generate(
        n=16, seed=5, pool=pool)


def test_omnirouter_in_front_serves_every_request():
    router, ds = _router_pool()
    _, peps = _endpoints()
    srv = MultiLLMServer(peps, router)
    vocab_cfg = peps[0].cfg
    for rid, q in enumerate(ds.queries):
        srv.submit(Request(rid, encode_for_config(vocab_cfg, q, 24),
                           max_new=5))
    done = srv.run(lambda reqs: ds.subset(np.array([r.rid for r in reqs])))
    assert sorted(r.rid for r in done) == list(range(ds.n))
    assert all(r.done and len(r.output) == 5 for r in done)
    assert {r.endpoint for r in done} <= {0, 1}
    assert srv.route_calls >= 1 and srv.route_seconds > 0
    assert all(_drained(e) for e in peps)


class _Table:
    """Fixed (capability, cost) rows per request id behind the JAX host
    predict path (``predict_arrays``): row ``input_len - 1`` (padding rows,
    input_len 0, get zeros)."""

    def __init__(self, n, m, seed=0):
        # model j: better and dearer with j (a cheap draft beside a strong
        # verifier, the pairing a speculative column prices)
        rng = np.random.default_rng(seed)
        j = np.arange(m)[None, :]
        self.cap = (0.3 + 0.6 * j / max(m - 1, 1) + rng.uniform(
            -0.1, 0.1, (n, m))).astype(np.float32)
        self.cost = (rng.uniform(0.5, 1.5, (n, m)) * 1e-3
                     * 10.0 ** j).astype(np.float32)

    def _rows(self, input_len):
        idx = np.asarray(input_len, int) - 1
        ok = (idx >= 0)[:, None]
        i = np.maximum(idx, 0)
        return (np.where(ok, self.cap[i], 0.0).astype(np.float32),
                np.where(ok, self.cost[i], 0.0).astype(np.float32))

    def predict_arrays(self, batch):
        cap, cost = self._rows(batch.input_len)
        return cap, None, cost


class _PortTable(_Table):
    """The same rows behind the port's device predict contract."""

    token_len = 4
    device = torch.device("cpu")

    def device_inputs(self):
        return None

    def predict_device(self, inputs, toks, input_len, price_in, price_out):
        cap, cost = self._rows(input_len.numpy())
        return torch.from_numpy(cap), None, torch.from_numpy(cost)


def _table_features(batch_cls, m):
    """route_features for a server: each request's row of the table."""
    def features(reqs):
        class _Features:
            def route_batch(self, loads, counts, with_truth=False):
                return batch_cls(
                    queries=["q"] * len(reqs),
                    input_len=np.array([r.rid + 1.0 for r in reqs]),
                    price_in=np.ones(m), price_out=np.ones(m),
                    loads=np.asarray(loads, float),
                    counts=np.asarray(counts, float))
        return _Features()
    return features


@pytest.mark.parametrize("case", ["quality", "quality+pair", "budget+horizon"])
def test_stream_over_omnirouter_matches_jax(case):
    """stream=True over OmniRouter: padded, masked windows (the blocked
    solve), in lockstep with the JAX server."""
    pairs = "pair" in case
    if pairs:
        jeps, peps = _endpoints(arches=(ARCHS[0], ARCHS[0]), seeds=(7, 0))
    else:
        jeps, peps = _endpoints()
    n_req = 14
    table = _Table(n_req, 2, seed=1)
    ptable = _PortTable(n_req, 2, seed=1)
    kw = {}
    if "budget" in case:
        kw["budget"] = float(table.cost.min(1).sum() * 1.5)
    else:
        kw["alpha"] = 0.7
    extra = {"horizon": 20} if "horizon" in case else {}
    jpol = JaxRouter(table, JaxRCfg(spec_pairs=(JaxPair(0, 1, k=3),)
                                    if pairs else (), **kw))
    ppol = OmniRouter(ptable, RouterConfig(spec_pairs=(SpecPair(0, 1, k=3),)
                                          if pairs else (), **kw))
    js = jax_engine.MultiLLMServer(
        jeps, jpol, stream=True, window_steps=2.0,
        spec_pairs=(JaxPair(0, 1, k=3),) if pairs else (), **extra)
    ps = MultiLLMServer(peps, ppol, stream=True, window_steps=2.0,
                        spec_pairs=(SpecPair(0, 1, k=3),) if pairs else (),
                        **extra)
    rng = np.random.RandomState(6)
    arrive = np.round(np.cumsum(rng.exponential(0.7, n_req)), 2)
    for rid, ((toks, m), at) in enumerate(zip(_requests(n_req, seed=5),
                                              arrive)):
        js.submit(jax_engine.Request(rid, toks, max_new=m), at_step=at)
        ps.submit(Request(rid, toks, max_new=m), at_step=at)
    want = {r.rid: (r.endpoint, list(r.output), r.admit_step)
            for r in js.run(_table_features(JaxBatch, 2))}
    got = {r.rid: (r.endpoint, list(r.output), r.admit_step)
           for r in ps.run(_table_features(RouteBatch, 2))}
    assert got == want and len(got) == n_req
    assert ps.windows == js.windows > 1
    assert ps.dual_iters == js.dual_iters > 0
    assert ps.spec_rounds == js.spec_rounds
    if pairs:
        assert ps.spec_rounds > 0
        assert np.array_equal(ppol.acceptance.rounds, jpol.acceptance.rounds)
    assert all(_drained(e) for e in peps)


def test_restart_endpoint_matches_jax_under_churn():
    arch = ARCHS[0]
    jc = dataclasses.replace(jax_smoke(arch), dtype=jnp.float32)
    pc = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    je = jax_engine.RestartEndpoint(jc, max_concurrency=3, t_max=16, seed=2)
    je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
    pe = RestartEndpoint(pc, max_concurrency=3, t_max=16, device="cpu",
                         params=convert.model_params_from_numpy(
                             pc, jax.tree.map(np.asarray, je.params), "cpu"))
    todo = _requests(6, seed=8)               # ragged prompts: left pads
    jreqs = [jax_engine.Request(i, t, max_new=m) for i, (t, m) in
             enumerate(todo)]
    preqs = [Request(i, t, max_new=m) for i, (t, m) in enumerate(todo)]
    nxt = 0
    while nxt < len(todo) or pe.active_count():
        while nxt < len(todo) and pe.has_capacity():
            je.admit(jreqs[nxt])
            pe.admit(preqs[nxt])
            nxt += 1
        assert [r.rid for r in je.step()] == [r.rid for r in pe.step()]
        assert [r.rid for r in je.active] == [r.rid for r in pe.active]
    for jr, pr in zip(jreqs, preqs):
        assert pr.done and len(pr.output) == pr.max_new
        assert pr.output == jr.output
    assert (pe.batch_reprefills, pe.prefill_calls) == (
        je.batch_reprefills, je.prefill_calls)
    assert (pe.busy_steps, pe.decoded_tokens) == (je.busy_steps,
                                                  je.decoded_tokens)
    assert pe.batch_reprefills > len(todo)
    # staticcheck: ignore[SC08] -- RestartEndpoint keeps no page pool and
    # no slot free lists: drained is an empty batch with no cache
    assert pe.active_count() == 0 and pe._cache is None


@pytest.mark.parametrize("second", ["gemma3-4b", "hymba-1.5b"])
def test_server_paged_matches_restart_engine(second):
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 500, (9,)).astype(np.int32) for _ in range(9)]
    outs, stats = {}, {}
    for name, cls in (("paged", Endpoint), ("restart", RestartEndpoint)):
        eps = [cls(dataclasses.replace(get_smoke_config(a),
                                       dtype=torch.float32),
                   max_concurrency=3, seed=i, device="cpu")
               for i, a in enumerate(["h2o-danube-3-4b", second])]
        srv = MultiLLMServer(eps, BalanceAware(), batch_size=6)
        for i, p in enumerate(prompts):
            srv.submit(Request(rid=i, tokens=p, max_new=6))
        done = srv.run(null_route_features)
        assert len(done) == len(prompts)
        outs[name] = {r.rid: (r.endpoint, tuple(r.output)) for r in done}
        stats[name] = sum(e.batch_reprefills for e in eps)
    assert outs["paged"] == outs["restart"]
    assert stats["paged"] == 0
    assert stats["restart"] > 0        # the baseline restarts on every event


def test_restart_endpoint_refuses_a_speculative_pair():
    eps = [RestartEndpoint(dataclasses.replace(
        get_smoke_config(ARCHS[0]), dtype=torch.float32), device="cpu")
        for _ in range(2)]
    with pytest.raises(NotImplementedError, match="paged"):
        MultiLLMServer(eps, BalanceAware(), spec_pairs=(SpecPair(0, 1, k=3),))


SIX_POOL = ("h2o-danube-3-4b", "internlm2-20b", "qwen2-72b", "gemma3-4b",
            "hymba-1.5b", "xlstm-350m")


def test_six_model_pool_matches_jax():
    """The reference's serving pool: two recurrent endpoints (exact-length
    prefill, per-slot state) beside four attention ones."""
    jeps, peps = _endpoints(seeds=range(6), arches=SIX_POOL)
    assert [e._has_recurrent for e in peps] == [False] * 4 + [True] * 2
    assert [e._has_kv for e in peps] == [True] * 5 + [False]
    js = jax_engine.MultiLLMServer(jeps, JaxBA())
    ps = MultiLLMServer(peps, BalanceAware())
    for rid, (toks, m) in enumerate(_requests(14, seed=9)):
        js.submit(jax_engine.Request(rid, toks, max_new=m))
        ps.submit(Request(rid, toks, max_new=m))
    want = {r.rid: (r.endpoint, list(r.output))
            for r in js.run(jax_engine.null_route_features)}
    got = {r.rid: (r.endpoint, list(r.output))
           for r in ps.run(null_route_features)}
    assert got == want and len(got) == 14
    assert {ep for ep, _ in got.values()} == set(range(6))
    assert all(_drained(e) and e.batch_reprefills == 0 for e in peps)
    for j in (4, 5):                    # hymba, xLSTM as a pair column
        for srv, pol, pair, eps in (
                (jax_engine.MultiLLMServer, JaxBA, JaxPair, jeps),
                (MultiLLMServer, BalanceAware, SpecPair, peps)):
            with pytest.raises(NotImplementedError):
                srv(eps, pol(), spec_pairs=(pair(0, j, k=3),))
