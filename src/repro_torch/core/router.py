"""OmniRouter facade: two-stage routing (predict → constrained optimize).

The port of ``repro.core.router``.  ``route``
consumes a :class:`RouteBatch`: the host tokenizes the query text, and
everything after — featurize → retrieve → vote → blend → dual solve →
repair → polish — runs on the predictor's device, with no host round-trip
between the predictor and the solve (on the card: the retrieval-vote and
dual-solve CUDA kernels).  ``route_window`` threads a :class:`DualState`
through a streaming-tuned solver (scale-free subgradient + stall early exit)
so window k+1 warm-starts from window k.  A padded window (``n_valid``, as
``core.control.StreamController`` pads every window to a power-of-two
bucket) takes the blocked, masked solve, whose per-iteration statistics run
in the hand-written shard-statistics kernel on the card.

Speculative pair columns (``RouterConfig.spec_pairs``): ``route_window``
splices the (draft, verify) columns between predict and solve
(``core.speculative.expand_pair_columns``, on the device, priced by the
live acceptance EWMA), so the solve and the warm state span M + P columns.

Under an active query mesh (``common.sharding.use_mesh(query_mesh(),
query_rules())`` on every rank) each rank tokenizes and predicts only its
contiguous rows of the batch, with the predictor and its VectorStore
replicated (the reference's ``_sharded_predict``: the retrieval vote runs
on each rank's shard, and no collective is needed), and feeds them to the
query-sharded solve (``DualSolver(local=True)``); every rank returns the
whole assignment.

With ``robust=True`` the streaming solve runs against the quality
lower-confidence bound ``q - kappa*sigma`` (``DualSolver.robust``), taken
after the pair columns are spliced in.  With ``ledgersan`` on
(``repro_torch.analysis.sanitize``), every window's state transition is
checked for a monotone ledger on the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.data import tokenizer

from .baselines import Policy, RouteBatch
from .optimizer import DualSolver, DualState, init_dual_state
from .speculative import (AcceptanceTracker, expand_pair_columns,
                          pair_index_arrays)


@dataclasses.dataclass
class RouterConfig:
    alpha: float = 0.75          # quality constraint (paper default)
    budget: Optional[float] = None   # set -> budget-controllable mode
    iters: int = 150
    lr_quality: float = 4.0
    lr_budget: float = 50.0
    lr_workload: float = 0.5
    use_assign_kernel: bool = False  # config parity; the device decides
    # tighten the predicted-quality constraint during primal polish so
    # prediction noise doesn't push the realized SR below alpha
    alpha_margin: float = 0.03
    # streaming solver (route_window only)
    lr_stream: float = 3.0
    stall_tol: float = 0.01
    stall_patience: int = 3
    # query-axis shards of the streaming solver: >1 runs the blocked dual
    # solve (all shards on one device, or shards/D a rank under a query
    # mesh of D ranks)
    shards: int = 1
    # robust=True solves streaming windows against the quality lower-
    # confidence bound q - kappa*sigma (Bernoulli sigma); kappa=0 is
    # bit-identical to robust off
    robust: bool = False
    kappa: float = 1.0
    # speculative cascade: (draft, verify) SpecPair columns grow the
    # streaming solve to (N, M + P); () leaves the solve as it is
    spec_pairs: tuple = ()


class OmniRouter(Policy):
    """ECCOS with a pluggable predictor (trained / retrieval / hybrid) that
    implements the device predict contract (``token_len``,
    ``device_inputs``, ``predict_device``, ``device``)."""

    # StreamController opt-in: pad arrival windows to power-of-two buckets
    # (multiples of the shard count) and pass n_valid, so the blocked solve
    # divides every window evenly into its shards
    pads_windows = True

    def __init__(self, predictor, cfg: RouterConfig = RouterConfig(),
                 name: str = "ECCOS"):
        self.predictor = predictor
        self.cfg = cfg
        self.name = name
        mode = "budget" if cfg.budget is not None else "quality"
        self.solver = DualSolver(
            mode=mode, iters=cfg.iters,
            lr_constraint=cfg.lr_budget if mode == "budget" else cfg.lr_quality,
            lr_workload=cfg.lr_workload, use_kernel=cfg.use_assign_kernel)
        self.stream_solver = DualSolver(
            mode=mode, iters=cfg.iters, lr_constraint=cfg.lr_stream,
            lr_workload=cfg.lr_workload, use_kernel=cfg.use_assign_kernel,
            stall_tol=cfg.stall_tol, stall_patience=cfg.stall_patience,
            norm_grad=True, shards=cfg.shards, robust=cfg.robust,
            kappa=cfg.kappa)
        # speculative cascade: pair columns + the acceptance EWMAs that
        # reprice them (the engine records verify rounds into the tracker)
        self.pairs = tuple(cfg.spec_pairs)
        self.acceptance = (AcceptanceTracker(self.pairs) if self.pairs
                           else None)
        self.route_seconds = 0.0
        self.predict_seconds = 0.0
        self._iters_pending: list = []  # device scalars awaiting one sync
        self._dual_iters = 0
        self.windows = 0
        # the last call's wall split: tokenize_s, predict_solve_s, polish_s
        # and the repair/polish move counts
        self.last_timing: Dict[str, float] = {}

    @property
    def dual_iters(self) -> int:
        """Total streaming dual iterations run (synced lazily on read)."""
        if self._iters_pending:
            self._dual_iters += int(torch.stack(self._iters_pending).sum())
            self._iters_pending.clear()
        return self._dual_iters

    def observe(self, texts, correct, out_len):
        obs = getattr(self.predictor, "observe", None)
        return None if obs is None else obs(texts, correct, out_len)

    def _thresholds(self):
        """(solver threshold, polish threshold)."""
        if self.cfg.budget is not None:
            return self.cfg.budget, self.cfg.budget
        return (self.cfg.alpha,
                min(self.cfg.alpha + self.cfg.alpha_margin, 1.0))

    def _predict(self, batch: RouteBatch, solver: DualSolver):
        """Tokenize on the host, predict on the device: (cap, cost, loads,
        the time predicting began, whether the rows are this rank's).
        Under a query mesh (``solver``'s plan) each rank takes its own
        contiguous rows (the reference's ``_sharded_predict``)."""
        dev = self.predictor.device
        queries, input_len = batch.queries, batch.input_len
        mesh, axes, gshards = solver._plan()
        if mesh is not None:
            n = len(queries)
            solver._check_divisible(n, gshards)
            d, r = mesh.axis_size(axes), mesh.axis_index(axes)
            rows = slice(r * (n // d), (r + 1) * (n // d))
            queries, input_len = queries[rows], np.asarray(input_len)[rows]
        t0 = time.perf_counter()
        toks = torch.as_tensor(tokenizer.encode_batch(
            queries, self.predictor.token_len), device=dev)
        t1 = time.perf_counter()
        self.last_timing = {"tokenize_s": t1 - t0}
        self.predict_seconds += t1 - t0

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        with torch.no_grad():
            cap, _, cost = self.predictor.predict_device(
                self.predictor.device_inputs(), toks, f32(input_len),
                f32(batch.price_in), f32(batch.price_out))
        return cap, cost, f32(batch.available), t1, mesh is not None

    def _finish(self, x, stats, t1):
        x = x.cpu().numpy()
        wall = time.perf_counter() - t1
        self.route_seconds += wall
        self.last_timing.update(stats)
        self.last_timing["predict_solve_s"] = wall - stats["polish_s"]
        return x

    def route(self, batch: RouteBatch, rng=None) -> np.ndarray:
        cap, cost, avail, t1, local = self._predict(batch, self.solver)
        threshold, polish_threshold = self._thresholds()
        stats: dict = {}
        x, _ = self.solver.route_arrays(cost, cap, threshold, avail,
                                        polish_threshold=polish_threshold,
                                        stats=stats, local=local)
        return self._finish(x, stats, t1)

    def window_multiple(self) -> int:
        """Bucket sizes must divide into this many query shards (the
        streaming solver's plan: under a query mesh, a multiple of its
        ranks)."""
        return self.stream_solver._plan()[2]

    def route_window(self, batch: RouteBatch, state: Optional[DualState],
                     *, share: float = 1.0, rng=None,
                     n_valid: Optional[int] = None):
        """Streaming window: predict → (pair columns) → warm-started
        windowed solve, all on the predictor's device.  ``n_valid`` marks
        the valid-row prefix of a padded window.  Returns ``(assignment,
        new_state)``."""
        if state is None:
            # pair columns extend the multiplier/ledger axis: the warm
            # state spans all M + P columns of the streaming solve
            state = init_dual_state(batch.m + len(self.pairs),
                                    self.predictor.device)
        state_in = state
        threshold = (self.cfg.budget if self.cfg.budget is not None
                     else self.cfg.alpha)
        cap, cost, avail, t1, local = self._predict(batch,
                                                    self.stream_solver)
        if self.pairs:
            e_acc = torch.as_tensor(self.acceptance.expected(),
                                    dtype=torch.float32, device=cost.device)
            cost, cap = expand_pair_columns(cost, cap,
                                            *pair_index_arrays(self.pairs),
                                            e_acc)
        stats: dict = {}
        x, info, state = self.stream_solver.route_window(
            cost, cap, threshold, avail, state, share=share,
            polish_margin=self.cfg.alpha_margin, n_valid=n_valid,
            stats=stats, local=local)
        if _sanitize.active("ledgersan"):
            _sanitize.check_state_monotone(state_in, state,
                                           where="OmniRouter.route_window")
        # iters_run stays on the device; dual_iters sums lazily on read
        self._iters_pending.append(info.iters_run)
        self.windows += 1
        return self._finish(x, stats, t1), state


def evaluate_assignment(ds, x: np.ndarray) -> Dict[str, float]:
    """True SR and true $ cost of an assignment (uses ground truth)."""
    n = ds.n
    x = np.asarray(x)
    sr = float(ds.correct[np.arange(n), x].mean())
    cost = float(ds.cost_matrix()[np.arange(n), x].sum())
    return {"success_rate": sr, "cost": cost}
