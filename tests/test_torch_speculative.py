"""The port's speculative cascade plane against the JAX package.

- ``SpecPair`` validation, ``expand_pair_columns`` (P = 0 returns its
  inputs; pair pricing ``c_d + c_v / max(e, ACC_EPS)`` and the verify
  model's quality, bit for bit) and the ``AcceptanceTracker`` EWMA over a
  random sequence of rounds, all against the JAX versions.
- ``OmniRouter.route_window`` with a pair column over padded windows
  (``n_valid``), ``shards`` 1 and 4, warm across three windows with the
  tracker moving between them: ``x`` exact against the JAX router on the
  same predictions, the (M + P)-column ledger (budget spent, quality
  deficit) within 1e-5 relative, and the iterations of each window within
  one of JAX's.  That last tolerance is ROADMAP C4: window 1 at one shard
  runs a ~120-iteration normalized ascent along the constraint boundary,
  whose stall test compares a relative residual with its tolerance; the
  float32 sums of XLA and PyTorch differ in order, and the exit lands one
  iteration apart (the JAX solver itself ends that window after 118
  iterations at one shard and after 5 at four, from the sum order alone).
- The speculative server on the float32 smoke h2o-danube-3-4b, and on
  dbrx-132b's (the MoE family; the reference's
  ``test_speculative_matches_strong_only_moe``) (the JAX
  test's prompts of 5, 11 and 3 tokens, k = 3, ``max_new`` 9 + i, a draft
  with other weights): output equal to the port's strong-only decode AND to
  the JAX speculative server on the same parameters, and the same number of
  rounds; with identical weights every draft is accepted (12 tokens at
  k = 4 in 3 rounds).
- Rollback releases only the pages past the accepted prefix (checked on the
  allocator and the block table: the port has no PageSan), both allocators
  drain; recurrent endpoints and ``health`` are refused with pairs.
- Routed dispatch over an all-pair policy: pair-column assignments go
  through ``admit_spec``, outputs equal strong-only, verify rounds feed the
  policy's tracker.

Greedy tokens are compared exactly: the logits agree to ~1e-5 (see
``tests/test_torch_models.py``), far inside these models' top-2 gaps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import OmniRouter as JaxRouter  # noqa: E402
from repro.core import RouterConfig as JaxRCfg  # noqa: E402
from repro.core import speculative as jspec  # noqa: E402
from repro.core.baselines import RouteBatch as JaxBatch  # noqa: E402
from repro.core.baselines import pad_batch as jax_pad  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import OmniRouter, RouteBatch, RouterConfig  # noqa: E402
from repro_torch.core import pad_batch  # noqa: E402
from repro_torch.core.speculative import (ACC_EPS,  # noqa: E402
                                          AcceptanceTracker, SpecPair,
                                          expand_pair_columns,
                                          pair_index_arrays)
from repro_torch.serving.engine import (Endpoint, MultiLLMServer,  # noqa: E402
                                        Request, _EngineExecutor,
                                        null_route_features)

ARCH = "h2o-danube-3-4b"
EP = dict(max_concurrency=3, t_max=64, page_size=8, sync_every=4)


def test_spec_pair_validation_and_tracker_match_jax():
    for bad in (dict(draft=1, verify=1), dict(draft=0, verify=1, k=0)):
        with pytest.raises(ValueError):
            SpecPair(**bad)
    assert SpecPair(0, 1).k == jspec.SpecPair(0, 1).k == 4
    assert ACC_EPS == jspec.ACC_EPS
    shape = ((0, 1, 4), (2, 1, 2), (1, 0, 8))
    got = AcceptanceTracker([SpecPair(*p) for p in shape], beta=0.7)
    want = jspec.AcceptanceTracker([jspec.SpecPair(*p) for p in shape],
                                   beta=0.7)
    assert np.array_equal(got.expected(), want.expected())
    rng = np.random.RandomState(0)
    for _ in range(40):
        p, n = int(rng.randint(3)), float(rng.randint(-2, 11))
        got.record(p, n)
        want.record(p, n)
        assert np.array_equal(got.expected(), want.expected())
    assert np.array_equal(got.rounds, want.rounds)
    view = got.expected()
    view[:] = 0.0
    assert got.expected()[0] > 0.0          # a copy, not the state


def test_expand_pair_columns_matches_jax():
    rng = np.random.default_rng(0)
    cost = rng.uniform(0.1, 2.0, (16, 4)).astype(np.float32)
    qual = rng.uniform(0.0, 1.0, (16, 4)).astype(np.float32)
    c, q = torch.from_numpy(cost), torch.from_numpy(qual)
    c0, q0 = expand_pair_columns(c, q, (), (), None)
    assert c0 is c and q0 is q              # P = 0: the inputs themselves
    pairs = ((0, 3, 4), (1, 2, 2))
    didx, vidx = pair_index_arrays([SpecPair(*p) for p in pairs])
    e = np.array([2.5, 0.01], np.float32)   # the second below the floor
    c1, q1 = expand_pair_columns(c, q, didx, vidx, torch.from_numpy(e))
    jc, jq = jspec.expand_pair_columns(jnp.asarray(cost), jnp.asarray(qual),
                                       didx, vidx, jnp.asarray(e))
    assert c1.shape == (16, 6) and q1.shape == (16, 6)
    assert np.array_equal(c1.numpy(), np.asarray(jc))
    assert np.array_equal(q1.numpy(), np.asarray(jq))


# -- router: pair columns over padded windows ----------------------------------

M_BASE, N_ALL = 3, 256


def _table(seed=0):
    rng = np.random.default_rng(seed)
    cap = rng.uniform(0.0, 1.0, (N_ALL, M_BASE)).astype(np.float32)
    cost = (rng.uniform(0.2, 3.0, (N_ALL, M_BASE)) * 1e-3).astype(np.float32)
    return cap, cost


class _JaxTable:
    """Host-path JAX predictor: row ``input_len - 1`` of fixed tables
    (padding rows, input_len 0, get zeros)."""

    def __init__(self, cap, cost):
        self.cap, self.cost = cap, cost

    def predict_arrays(self, batch):
        idx = np.asarray(batch.input_len, int) - 1
        ok = (idx >= 0)[:, None]
        return (np.where(ok, self.cap[idx], 0.0).astype(np.float32), None,
                np.where(ok, self.cost[idx], 0.0).astype(np.float32))


class _PortTable:
    """The same predictions through the port's device predict contract."""

    token_len = 4
    device = torch.device("cpu")

    def __init__(self, cap, cost):
        self.cap, self.cost = torch.from_numpy(cap), torch.from_numpy(cost)

    def device_inputs(self):
        return None

    def predict_device(self, inputs, toks, input_len, price_in, price_out):
        idx = input_len.long() - 1
        ok = (idx >= 0)[:, None]
        i = idx.clamp(min=0)
        return (torch.where(ok, self.cap[i], 0.0), None,
                torch.where(ok, self.cost[i], 0.0))


def _window(rows, n_pad, avail):
    kw = dict(queries=["q"] * len(rows),
              input_len=np.asarray(rows, np.float64) + 1.0,
              price_in=np.ones(M_BASE), price_out=np.ones(M_BASE),
              loads=np.asarray(avail, float), counts=np.zeros(len(avail)))
    return (pad_batch(RouteBatch(**kw), n_pad),
            jax_pad(JaxBatch(**kw), n_pad))


@pytest.mark.parametrize("shards", [1, 4])
def test_route_window_pair_columns_match_jax(shards):
    cap, cost = _table()
    pairs = ((0, 2, 4),)
    kw = dict(alpha=0.6, shards=shards)
    pr = OmniRouter(_PortTable(cap, cost), RouterConfig(
        spec_pairs=tuple(SpecPair(*p) for p in pairs), **kw))
    jr = JaxRouter(_JaxTable(cap, cost), JaxRCfg(
        spec_pairs=tuple(jspec.SpecPair(*p) for p in pairs), **kw))
    assert pr.window_multiple() == shards and pr.pads_windows
    avail = np.array([20.0, 30.0, 25.0, 40.0])        # M + P columns
    ps = js = None
    start, steps = 0, (0.0, 0.0)
    for w, nv in enumerate((50, 64, 33)):
        pb, jb = _window(range(start, start + nv), 64, avail)
        start += nv
        xp, ps = pr.route_window(pb, ps, share=1.0 / (3 - w), n_valid=nv)
        xj, js = jr.route_window(jb, js, share=1.0 / (3 - w), n_valid=nv)
        assert np.array_equal(xp, np.asarray(xj)), w
        assert ps.lam_load.shape == (M_BASE + len(pairs),)
        for field in ("budget_spent", "sr_deficit"):
            assert np.allclose(float(getattr(ps, field)),
                               float(getattr(js, field)), rtol=1e-5,
                               atol=1e-9), (w, field)
        iters = (float(ps.steps) - steps[0], float(js.steps) - steps[1])
        assert abs(iters[0] - iters[1]) <= 1, (w, iters)
        steps = (float(ps.steps), float(js.steps))
        for _ in range(w + 2):               # acceptance reprices the pair
            pr.acceptance.record(0, 4.0)
            jr.acceptance.record(0, 4.0)
    assert np.array_equal(pr.acceptance.expected(), jr.acceptance.expected())
    assert pr.windows == 3 and pr.dual_iters == int(float(ps.steps))


# -- the engine's speculative plane ---------------------------------------------

def _endpoint_pair(seeds=(7, 0), params_from=None, arch=ARCH):
    """(JAX endpoints, port endpoints) on the same float32 parameters, one
    per seed, for the float32 smoke config of ``arch``."""
    jc = dataclasses.replace(jax_smoke(arch), dtype=jnp.float32)
    pc = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    jeps, peps = [], []
    for seed in seeds:
        je = jax_engine.Endpoint(jc, seed=seed, **EP)
        je.params = jax.tree.map(lambda a: a.astype(jnp.float32), je.params)
        params = convert.model_params_from_numpy(
            pc, jax.tree.map(np.asarray, je.params), "cpu")
        jeps.append(je)
        peps.append(Endpoint(pc, params=params, device="cpu", **EP))
    return jeps, peps


def _prompts(vocab, sizes=(5, 11, 3), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=n).astype(np.int32) for n in sizes]


def _drive(srv, executor, reqs):
    for r in reqs:
        srv.admit_spec(r, 0)
    steps = 0
    while srv._spec:
        executor.advance(None)
        steps += 1
        assert steps < 200


def _strong_only(ep, prompts, max_new):
    outs = []
    for i, p in enumerate(prompts):
        r = Request(100 + i, p, max_new=max_new[i])
        ep.admit(r)
        while ep.active_count():
            ep.step()
        outs.append(r.output)
    return outs


def _drained(ep):
    return (len(ep.alloc.free_pages) == ep.alloc.n_pages - 1
            and sorted(ep.alloc.free_slots) == list(range(ep.L))
            and not ep.block_table.any() and not ep.spec_slots)


def test_spec_server_matches_strong_only_and_jax():
    _spec_against_strong_only_and_jax(ARCH)


def test_spec_server_matches_strong_only_and_jax_moe():
    """The same on the MoE family (dbrx-132b's smoke config), in lockstep
    with the reference's ``test_speculative_matches_strong_only_moe``."""
    _spec_against_strong_only_and_jax("dbrx-132b")


def _spec_against_strong_only_and_jax(arch):
    """A (draft seed 7, verify seed 0) pair at k = 3 over three prompts:
    every output equals the verify model's strong-only decode and the JAX
    speculative server's, with as many rounds as JAX; both allocators
    drain."""
    jeps, peps = _endpoint_pair(arch=arch)
    prompts = _prompts(peps[0].cfg.vocab_size)
    max_new = [9 + i for i in range(3)]
    psrv = MultiLLMServer(peps, None, spec_pairs=(SpecPair(0, 1, k=3),))
    jsrv = jax_engine.MultiLLMServer(
        jeps, policy=None, spec_pairs=(jspec.SpecPair(0, 1, k=3),))
    preqs = [Request(i, p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, max_new))]
    jreqs = [jax_engine.Request(i, p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, max_new))]
    _drive(psrv, _EngineExecutor(psrv, 10_000), preqs)
    _drive(jsrv, jsrv._executor_cls(jsrv, 10_000), jreqs)
    strong = _strong_only(Endpoint(peps[1].cfg, params=peps[1].params,
                                   device="cpu", **EP), prompts, max_new)
    for r, jr, s in zip(preqs, jreqs, strong):
        assert r.done and len(r.output) == r.max_new
        assert r.output == s, (r.rid, r.output, s)
        assert r.output == jr.output
    assert psrv.spec_rounds == jsrv.spec_rounds > 0
    assert psrv.spec_emitted == jsrv.spec_emitted == sum(max_new)
    assert all(_drained(e) for e in peps)


def test_identical_weights_accept_every_draft():
    _, (ep,) = _endpoint_pair(seeds=(0,))
    eps = [ep, Endpoint(ep.cfg, params=ep.params, device="cpu", **EP)]
    srv = MultiLLMServer(eps, None, spec_pairs=(SpecPair(0, 1, k=4),))
    req = Request(0, _prompts(ep.cfg.vocab_size, (5,))[0], max_new=12)
    _drive(srv, _EngineExecutor(srv, 1000), [req])
    assert req.done and len(req.output) == 12
    assert srv.spec_rounds == 3 and srv.spec_emitted == 12   # 12 / k
    assert all(_drained(e) for e in eps)


def test_rollback_releases_only_pages_past_the_accepted_prefix():
    _, (ep,) = _endpoint_pair(seeds=(0,))
    req = Request(0, _prompts(ep.cfg.vocab_size, (5,))[0], max_new=8)
    slot = ep.admit_spec(req, k=3)
    assert slot in ep.spec_slots and ep.remaining[slot] == 0
    first = list(ep._slot_pages[slot])
    ep.ensure_pages(slot, 17 + 3)            # 3 pages of 8 positions
    grown = list(ep._slot_pages[slot])
    assert grown[:len(first)] == first and len(grown) == 3
    assert list(ep.block_table[slot, :3]) == grown
    free_before = len(ep.alloc.free_pages)
    ep.lens[slot] = 9                        # accepted prefix: 9 positions
    ep.rollback_pages(slot, 9)               # keeps ceil(9 / 8) = 2 pages
    assert ep._slot_pages[slot] == grown[:2]
    assert list(ep.block_table[slot, :2]) == grown[:2]
    assert not ep.block_table[slot, 2:].any()
    assert len(ep.alloc.free_pages) == free_before + 1
    assert grown[2] in ep.alloc.free_pages
    ep.rollback_pages(slot, 9)               # nothing more to release
    assert len(ep.alloc.free_pages) == free_before + 1
    ep.release_spec(slot)
    assert _drained(ep) and ep.lens[slot] == 0


def test_spec_guards_refuse_recurrent_endpoints_and_health():
    _, (ep,) = _endpoint_pair(seeds=(0,))

    class _Recurrent:
        cfg = ep.cfg
        _has_recurrent, _has_kv = True, True
        L = 2

    with pytest.raises(NotImplementedError, match="pure-attention"):
        MultiLLMServer([_Recurrent(), ep], None,
                       spec_pairs=(SpecPair(0, 1, k=3),))
    with pytest.raises(NotImplementedError, match="health"):
        MultiLLMServer([ep, ep], None, health=True,
                       spec_pairs=(SpecPair(0, 1, k=3),))


class _AllPair:
    """Policy routing every query to the first pair column."""

    def __init__(self, pairs):
        self.acceptance = AcceptanceTracker(pairs)

    def route(self, batch, rng=None):
        # null_route_features spans every column: the last is pair 0
        return np.full(batch.n, batch.m - 1, int)


def test_routed_dispatch_runs_pairs_and_feeds_acceptance():
    _, peps = _endpoint_pair()
    pairs = (SpecPair(0, 1, k=3),)
    pol = _AllPair(pairs)
    srv = MultiLLMServer(peps, pol, batch_size=2, spec_pairs=pairs)
    prompts = _prompts(peps[0].cfg.vocab_size, (5, 9, 7, 4), seed=1)
    for i, p in enumerate(prompts):
        srv.submit(Request(i, p, max_new=8))
    done = srv.run(null_route_features)
    assert sorted(r.rid for r in done) == list(range(len(prompts)))
    assert all(r.endpoint == len(peps) for r in done)     # pair column 0
    assert srv.spec_rounds > 0
    assert int(pol.acceptance.rounds[0]) == srv.spec_rounds
    assert srv.spec_emitted == sum(len(r.output) for r in done)
    strong = _strong_only(Endpoint(peps[1].cfg, params=peps[1].params,
                                   device="cpu", **EP), prompts, [8] * 4)
    for r in done:
        assert r.output == strong[r.rid], r.rid
    assert all(_drained(e) for e in peps)
