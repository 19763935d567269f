"""Routing policies over the array-based ``RouteBatch`` contract.

A :class:`RouteBatch` is the single routing interface shared by the
event-driven simulator (``core.scheduler``) and the real serving engine
(the serving engine): per-query feature arrays plus fleet state
(loads / in-flight counts).  ``QAServe`` is one *producer* of RouteBatches
(``QAServe.route_batch``), not the interface itself — a live engine can build
one straight from its request queue.

A NumPy copy of ``repro.core.baselines``.  Baselines from the paper's
evaluation (§4.2):
BA — balance-aware: least-loaded model, random tie-break.
S3 — length-bucket encoder (the trained ECCOS-T predictor), then the
     cheapest predicted cost within each model's capacity.
PO — perception-only decoder length predictor, also cost-adapted; realized
     here as a noisier single-neighbour retrieval length estimate.
random / oracle — bounds. Oracle knows true correctness and picks the
cheapest correct model (else the most capable), respecting workloads.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class RouteBatch:
    """One batch of queries to route, as arrays.

    ``queries`` is the raw text (featurization source for the predictors);
    everything else is numeric.  ``cost_true``/``correct_true`` carry ground
    truth when the producer has it (simulation; oracle policy) and are None
    in a live engine.
    """

    queries: List[str]
    input_len: np.ndarray               # (N,) input token lengths
    price_in: np.ndarray                # (M,) $ per 1k input tokens
    price_out: np.ndarray               # (M,) $ per 1k output tokens
    loads: np.ndarray                   # (M,) per-model concurrency limits
    counts: np.ndarray                  # (M,) in-flight per model
    cost_true: Optional[np.ndarray] = None     # (N, M) true $ (oracle/sim)
    correct_true: Optional[np.ndarray] = None  # (N, M) true correctness

    @property
    def n(self) -> int:
        return len(self.queries)

    @property
    def m(self) -> int:
        return len(self.price_in)

    @property
    def available(self) -> np.ndarray:
        """Remaining per-model capacity (never negative)."""
        return np.maximum(np.asarray(self.loads, float)
                          - np.asarray(self.counts, float), 0.0)


def pad_bucket(n: int, multiple: int = 1) -> int:
    """Smallest ``multiple * 2^k`` (plain ``2^k`` when multiple is 1) that
    holds ``n`` queries.  Streaming windows padded to these buckets compile
    O(log N) distinct shapes instead of one jit per window size, and every
    bucket divides evenly across ``multiple`` query shards."""
    n = max(1, int(n))
    if multiple <= 1:
        return 1 << (n - 1).bit_length()
    b = multiple
    while b < n:
        b <<= 1
    return b


def pad_batch(batch: RouteBatch, n_pad: int) -> RouteBatch:
    """Extend a batch to ``n_pad`` rows with inert padding (empty queries,
    zero lengths / ground truth).  Callers must pass the original row count
    as ``n_valid`` so the solver masks the padding out of every ledger sum
    (the blocked solve additionally zeroes the padded cost/quality rows, so
    the pad CONTENT provably cannot leak into the result)."""
    extra = n_pad - batch.n
    if extra <= 0:
        return batch

    def rows(a):
        if a is None:
            return None
        a = np.asarray(a)
        return np.concatenate([a, np.zeros((extra,) + a.shape[1:], a.dtype)])

    return RouteBatch(
        queries=list(batch.queries) + [""] * extra,
        input_len=rows(batch.input_len),
        price_in=batch.price_in, price_out=batch.price_out,
        loads=batch.loads, counts=batch.counts,
        cost_true=rows(batch.cost_true),
        correct_true=rows(batch.correct_true))


class Policy:
    name = "base"
    needs_truth = False   # True -> producers must fill cost_true/correct_true

    def prepare(self, train_ds):
        return self

    def route(self, batch: RouteBatch, rng=None) -> np.ndarray:
        """Assign each query in the batch to a pool model: (N,) int."""
        raise NotImplementedError

    def route_window(self, batch: RouteBatch, state, *, share: float = 1.0,
                     rng=None, n_valid: Optional[int] = None):
        """Streaming contract: route one arrival window, threading the
        stream state (an :class:`repro_torch.core.optimizer.DualState` for the
        dual controller).  Stateless policies — every baseline — ignore the
        state and ``share`` (this window's fraction of the remaining
        horizon) and just delegate to :meth:`route`; ``OmniRouter``
        overrides this with the warm-started windowed solver.  ``n_valid``
        marks the valid-row prefix of a padded window (see ``pad_batch``);
        the caller slices the assignment back, so stateless policies may
        simply route the whole padded batch."""
        return self.route(batch, rng=rng), state


def _capacity_greedy(pref_costs: np.ndarray, loads, counts, rng) -> np.ndarray:
    """Assign each query to its cheapest model with remaining capacity."""
    n, m = pref_costs.shape
    counts = np.zeros(m, int) if counts is None else counts.astype(int).copy()
    out = np.zeros(n, int)
    order = rng.permutation(n) if rng is not None else np.arange(n)
    for i in order:
        ranked = np.argsort(pref_costs[i])
        for j in ranked:
            if counts[j] < loads[j]:
                out[i] = j
                counts[j] += 1
                break
        else:
            out[i] = int(np.argmin(counts - loads))  # all full: least overfull
            counts[out[i]] += 1
    return out


class BalanceAware(Policy):
    name = "BA"

    def route(self, batch: RouteBatch, rng=None):
        rng = rng or np.random.RandomState(0)
        n, m = batch.n, batch.m
        counts = np.asarray(batch.counts).astype(int).copy()
        loads = np.asarray(batch.loads)
        out = np.zeros(n, int)
        for i in range(n):
            free = loads - counts
            best = np.flatnonzero(free == free.max())
            out[i] = rng.choice(best)
            counts[out[i]] += 1
        return out


class S3Cost(Policy):
    """Length-bucket predictor (encoder) -> cheapest predicted cost.
    ``device`` is where ``prepare`` fits the encoder (None: the card)."""

    name = "S3"

    def __init__(self, n_buckets: int = 10, steps: int = 200, device=None):
        self.n_buckets = n_buckets
        self.steps = steps
        self.device = device
        self.pred = None

    def prepare(self, train_ds):
        from .predictor import PredictorConfig, TrainedPredictor
        self.pred = TrainedPredictor(PredictorConfig(
            n_models=train_ds.m, n_buckets=self.n_buckets),
            device=self.device)
        self.pred.fit(train_ds, steps=self.steps, batch=48)
        return self

    def route(self, batch, rng=None):
        _, _, cost = self.pred.predict_arrays(batch)
        return _capacity_greedy(cost, batch.loads, batch.counts, rng)


class PerceptionOnly(Policy):
    """Generative length perception (noisy) -> cheapest predicted cost.
    ``device`` is where ``prepare`` builds the store (None: the card)."""

    name = "PO"

    def __init__(self, device=None):
        self.device = device
        self.ret = None

    def prepare(self, train_ds):
        from .retrieval import RetrievalPredictor
        self.ret = RetrievalPredictor(k=1, device=self.device).fit(train_ds)
        return self

    def route(self, batch, rng=None):
        _, _, cost = self.ret.predict_arrays(batch)
        return _capacity_greedy(cost, batch.loads, batch.counts, rng)


class RandomPolicy(Policy):
    name = "random"

    def route(self, batch, rng=None):
        rng = rng or np.random.RandomState(0)
        return _capacity_greedy(rng.rand(batch.n, batch.m),
                                batch.loads, batch.counts, rng)


class Oracle(Policy):
    """Upper bound: true correctness known (simulation only)."""

    name = "oracle"
    needs_truth = True

    def route(self, batch, rng=None):
        if batch.cost_true is None or batch.correct_true is None:
            raise ValueError("Oracle needs a RouteBatch with ground truth")
        # cheapest correct model; incorrect ones get +inf-ish penalty
        pref = batch.cost_true + (1 - batch.correct_true) * 1e3
        return _capacity_greedy(pref, batch.loads, batch.counts, rng)
