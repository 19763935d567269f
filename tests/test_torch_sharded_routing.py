"""The query-sharded routing plane on four gloo ranks, on the CPU.

One group of ranks is started once, by a module-scoped fixture, with
``repro_torch.launch.mesh.run_ranks`` (fresh interpreters meeting through a
file store, one thread each, killed together on a 60 s timeout), and runs
every case of (a) and (b); the tests below hold the ranks' results.  The
ranks load this file, so it imports no JAX at module level: the JAX
package is imported by the fixtures and tests, in this process.

(a) The sharded blocked solve, ``DualSolver`` under
    ``use_mesh(query_mesh(), query_rules())``, n 1,024 and m 6 as the
    reference's ``test_sharded_solver_bit_parity_8dev``, in both modes, at
    ``shards`` 4 and 8 (one and two local shards a rank), with
    ``norm_grad``: a cold solve, a padded window (``n_valid`` 1,000, garbage
    in the padding), the stall early exit (200 iterations, tolerance 0.5,
    patience 2) and three warm ``route_window`` windows (each rank passing
    only its rows, ``local=True``).  Against the port's one-rank blocked
    solve: ``x``, every ``SolveInfo`` and ``DualState`` field, bit for bit,
    on every rank.  Against the JAX package's single-device
    ``DualSolver(shards=...)`` with no mesh: ``x`` and ``iters_run`` exact,
    the ledger within 1e-5 relative and λ/λ2 within 1e-3 relative (the
    C4 drift, ``tests/test_torch_optimizer.py``'s blocked-window
    contract) or 1e-4 absolute (a λ the ascent drove near its clamp at 0
    keeps the absolute drift of the larger λ it came from: quality,
    shards 8, window 2 ends at λ 0.0037, 1.8e-5 from JAX's); not the
    failing 8-device tests (C2).  Each solve's
    all-gather bytes equal ``roofline.sharded_solve_bytes`` of the
    iterations its loop ran (``ref.loop_iterations``).
(b) The query-sharded stream: ``OmniRouter`` + ``StreamController`` over
    ``generate(n=300, seed=0)``'s test split, through one ECCOS-H
    predictor in both packages (the port's heads from seed 0, its store
    built from the training split, carried into the JAX package; the
    reference test trains the heads for 40 steps, which adds nothing to a
    parity check and takes minutes on a loaded CPU), windows of 37, 53 and
    30 padded to buckets of
    ``window_multiple() == 4``; each rank predicts its own rows.  Against
    the one-rank port and against the JAX single-device stream at
    ``shards`` 4: the reference test's contract (assignments bit for bit,
    the ledger's steps exact, λ within rtol 1e-4, atol 1e-5), with the
    ledger's two float sums (budget spent, quality deficit) within 1e-5
    relative where the reference asks them exact.  A rank's predictions of
    its rows are not bit for bit the whole window's: PyTorch's CPU float32
    sigmoid (the ECCOS-H gate) takes a vectorized path over whole vectors
    and a scalar one over a batch's tail, which differ in the last bit, so
    the same query's ``w`` can differ by an ulp between a 16-row and a
    64-row batch; the sums of the chosen predictions carry it (the
    reference test allows its λ the same drift, "the encoder matmuls
    retile across local sizes").  The solve fed the same predictions is
    bit for bit, (a).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.roofline import collective_bytes  # noqa: E402
from repro_torch.common.sharding import (query_mesh, query_rules,  # noqa: E402
                                         use_mesh)
from repro_torch.core import optimizer as popt  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402

WORLD = 4
TIMEOUT = 60.0
N, M = 1024, 6
MODES = {"quality": (0.55, 4.0), "budget": (0.3, 50.0)}
KINDS = ("cold", "masked", "stall", "stream")
CASES = [(mode, shards, kind) for mode in MODES for shards in (4, 8)
         for kind in KINDS]
LEDGER_RTOL = 1e-5
JAX_LAM_RTOL = 1e-3      # C4: tests/test_torch_optimizer.py FUSED_WARM_RTOL
JAX_LAM_ATOL = 1e-4      # a λ near its clamp at 0 (module docstring)
STREAM_WINDOWS = ((0, 37), (37, 53), (90, 30))
INFO = ("lam", "lam_load", "feasible", "cost", "quality", "counts",
        "objective", "iters_run")
STATE = ("lam", "lam_load", "budget_spent", "sr_deficit", "steps")


def _instance(seed, n_valid=None):
    rng = np.random.default_rng(seed)
    cost = (rng.uniform(0.2, 3.0, (N, M)) * 1e-3).astype(np.float32)
    quality = rng.uniform(0.0, 1.0, (N, M)).astype(np.float32)
    if n_valid is not None:                # garbage in the padding rows
        cost[n_valid:] = 7.0
        quality[n_valid:] = 0.5
    return cost, quality


def _case(mode, shards, kind):
    """(solver kwargs, calls): each call (cost, quality, thr, loads,
    n_valid, share) of a solve, or of a window for "stream"."""
    thr, lr = MODES[mode]
    kw = dict(mode=mode, iters=60, lr_constraint=lr, stall_tol=1e-4,
              norm_grad=True, shards=shards)
    loads = np.full((M,), 256.0, np.float32)
    seed = 10 * shards + KINDS.index(kind) + (mode == "budget")
    if kind == "stall":
        kw.update(iters=200, stall_tol=0.5, stall_patience=2)
    if kind == "stream":
        return kw, [(*_instance(seed + w, nv), thr, loads, nv,
                     1.0 / (3 - w))
                    for w, nv in enumerate((None, 1000, 777))]
    nv = 1000 if kind == "masked" else None
    return kw, [(*_instance(seed, nv), thr, loads, nv, None)]


def _run_case(solver, kind, calls, rank=0, ranks=1):
    """The case's calls on this process: (x, SolveInfo, DualState or None,
    all-gather bytes) each."""
    out, state = [], None
    for cost, quality, thr, loads, nv, share in calls:
        pmesh.reset_collectives()
        if kind == "stream":
            rows = N // ranks
            c, q = (torch.tensor(a[rank * rows:(rank + 1) * rows])
                    for a in (cost, quality))
            x, info, state = solver.route_window(
                c, q, thr, torch.tensor(loads), state, share=share,
                polish_margin=0.03, n_valid=nv, local=ranks > 1)
        else:
            x, info = solver.solve(torch.tensor(cost), torch.tensor(quality),
                                   thr, torch.tensor(loads), n_valid=nv)
        out.append((x, info, state,
                    collective_bytes()["all-gather"]))
    return out


def _rank(rank, world, device, args):
    """Rank body: every case of (a), then the stream (b), under the query
    mesh."""
    cases, predictor = args
    with use_mesh(query_mesh(), query_rules()):
        solves = {case: _run_case(popt.DualSolver(device="cpu", **kw),
                                  case[2], calls, rank, world)
                  for case, (kw, calls) in cases.items()}
        return solves, _stream(predictor)


@pytest.fixture(scope="module")
def ranks():
    """(the cases of (a), the predictor's arrays, each rank's results)."""
    from repro_torch.convert import predictor_params_to_numpy
    from repro_torch.core import HybridPredictor, PredictorConfig
    from repro_torch.data.qaserve import generate
    cases = {case: _case(*case) for case in CASES}
    train, _, _ = generate(n=300, seed=0).split(0.5, 0.0)
    pred = HybridPredictor(PredictorConfig(n_models=train.m), seed=0,
                           device="cpu").fit_store(train)
    vs = pred.retrieval.vstore
    arrays = (predictor_params_to_numpy(pred.trained.params),
              (vs.emb.numpy(), vs.labels.numpy(), vs.size))
    results = pmesh.run_ranks(f"{__file__}:_rank", WORLD, backend="gloo",
                              device="cpu", timeout=TIMEOUT,
                              args=(cases, arrays))
    return cases, arrays, results


@pytest.fixture(scope="module")
def sharded(ranks):
    cases, _, results = ranks
    return cases, [r[0] for r in results]


def _case_id(case):
    return f"{case[0]}-s{case[1]}-{case[2]}"


def _same(a, b) -> bool:
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_solve_is_the_one_rank_solve_bit_for_bit(sharded, case):
    args, results = sharded
    kw, calls = args[case]
    want = _run_case(popt.DualSolver(device="cpu", **kw), case[2], calls)
    for rank in range(WORLD):
        for w, ((x, info, st, _), (x0, info0, st0, _)) in enumerate(
                zip(results[rank][case], want)):
            assert _same(x, x0), (rank, w, "x")
            for f in INFO:
                assert _same(getattr(info, f), getattr(info0, f)), \
                    (rank, w, f)
            if st0 is not None:
                for f in STATE:
                    assert _same(getattr(st, f), getattr(st0, f)), \
                        (rank, w, f)
    if case[2] == "stall" and case[0] == "quality":
        assert int(want[0][1].iters_run) < 200       # the early exit fired


def _close(a, b, rtol, atol=1e-7):
    return np.allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                       rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_solve_holds_to_the_jax_single_device_solve(sharded, case):
    from repro.core import optimizer as jopt
    args, results = sharded
    kw, calls = args[case]
    solver, state = jopt.DualSolver(**kw), None
    for w, (cost, quality, thr, loads, nv, share) in enumerate(calls):
        x, info, st, _ = results[0][case][w]
        if case[2] == "stream":
            xj, ij, state = solver.route_window(
                cost, quality, thr, loads, state, share=share,
                polish_margin=0.03, n_valid=nv)
            for f in ("budget_spent", "sr_deficit"):
                assert _close(getattr(st, f), getattr(state, f),
                              LEDGER_RTOL), (w, f)
            assert float(st.steps) == float(state.steps)
        else:
            xj, ij = solver.solve(cost, quality, thr, loads, n_valid=nv)
        assert np.array_equal(x.numpy(), np.asarray(xj)), w
        assert int(info.iters_run) == int(ij.iters_run), w
        assert bool(info.feasible) == bool(ij.feasible), w
        assert np.array_equal(info.counts.numpy(), np.asarray(ij.counts))
        assert _close(info.lam, ij.lam, JAX_LAM_RTOL, JAX_LAM_ATOL), w
        assert _close(info.lam_load, ij.lam_load, JAX_LAM_RTOL,
                      JAX_LAM_ATOL), w


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_solve_gathers_the_stated_bytes(sharded, case):
    from repro_torch.analysis.roofline import sharded_solve_bytes
    from repro_torch.kernels.lagrangian_assign.ref import loop_iterations
    args, results = sharded
    kw, _ = args[case]
    for rank in range(WORLD):
        for x, info, _, gathered in results[rank][case]:
            loop = loop_iterations(kw["iters"], int(info.iters_run))
            assert gathered == sharded_solve_bytes(
                loop, kw["shards"], M, N, norm_grad=True), (rank, loop)


# --- (b) the query-sharded stream --------------------------------------------

def _stream(pred_args):
    """The three windows through OmniRouter + StreamController: (the
    assignments, the final DualState, window_multiple())."""
    from repro_torch.convert import (predictor_params_from_numpy,
                                     vector_store_from_numpy)
    from repro_torch.core import (HybridPredictor, OmniRouter,
                                  PredictorConfig, RouterConfig)
    from repro_torch.core.control import StreamController
    from repro_torch.data.qaserve import generate
    params, (emb, labels, size) = pred_args
    _, _, test = generate(n=300, seed=0).split(0.5, 0.0)
    pred = HybridPredictor(PredictorConfig(n_models=test.m),
                           params=predictor_params_from_numpy(params, "cpu"),
                           device="cpu")
    pred.retrieval.vstore = vector_store_from_numpy(emb, labels, size, "cpu")
    router = OmniRouter(pred, RouterConfig(alpha=0.6, iters=60, shards=4))
    ctrl = StreamController(router, horizon=test.n)
    loads, counts = np.full(test.m, 50.0), np.zeros(test.m)
    xs = [ctrl.route(test.subset(np.arange(i0, i0 + sz)), loads, counts)
          for i0, sz in STREAM_WINDOWS]
    return xs, ctrl.state, router.window_multiple()


@pytest.fixture(scope="module")
def sharded_stream(ranks):
    return [r[1] for r in ranks[2]]


@pytest.fixture(scope="module")
def one_rank_stream(ranks):
    return _stream(ranks[1])


def _hold_stream(xs, st, xs0, st0):
    for (i0, sz), a, b in zip(STREAM_WINDOWS, xs, xs0):
        assert len(a) == sz                         # padding sliced off
        assert np.array_equal(a, np.asarray(b)), (i0, sz)
    assert float(st.steps) == float(st0.steps)
    for f in ("budget_spent", "sr_deficit"):
        assert _close(getattr(st, f), getattr(st0, f), LEDGER_RTOL), f
    for f in ("lam", "lam_load"):
        assert np.allclose(np.asarray(getattr(st, f)),
                           np.asarray(getattr(st0, f)),
                           rtol=1e-4, atol=1e-5), f


@pytest.mark.parametrize("rank", range(WORLD))
def test_sharded_stream_is_the_one_rank_stream(sharded_stream,
                                               one_rank_stream, rank):
    xs, st, mult = sharded_stream[rank]
    assert mult == 4
    xs0, st0, mult0 = one_rank_stream
    assert mult0 == 4
    _hold_stream(xs, st, xs0, st0)


def test_sharded_stream_holds_to_the_jax_stream(ranks, sharded_stream):
    import jax
    import jax.numpy as jnp
    from repro.core.control import StreamController
    from repro.core.hybrid import HybridConfig, HybridPredictor
    from repro.core.predictor import PredictorConfig
    from repro.core.retrieval import VectorStore
    from repro.core.router import OmniRouter, RouterConfig
    from repro.data.qaserve import generate
    params, (emb, labels, size) = ranks[1]
    _, _, test = generate(n=300, seed=0).split(0.5, 0.0)
    pred = HybridPredictor(PredictorConfig(n_models=test.m), HybridConfig())
    pred.trained.params = jax.tree.map(jnp.asarray, params)
    pred.retrieval.vstore = VectorStore(emb.shape[1], labels.shape[1])
    pred.retrieval.vstore.emb = jnp.asarray(emb)
    pred.retrieval.vstore.labels = jnp.asarray(labels)
    pred.retrieval.vstore.size = size
    router = OmniRouter(pred, RouterConfig(alpha=0.6, iters=60, shards=4))
    ctrl = StreamController(router, horizon=test.n)
    loads, counts = np.full(test.m, 50.0), np.zeros(test.m)
    xs0 = [ctrl.route(test.subset(np.arange(i0, i0 + sz)), loads, counts)
           for i0, sz in STREAM_WINDOWS]
    xs, st, _ = sharded_stream[0]
    _hold_stream(xs, st, xs0, ctrl.state)
