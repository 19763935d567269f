"""ECCOS-H: the paper's hybrid retrieval-augmented predictor (§3.1).

The port of ``repro.core.hybrid``.  A trained dual-head encoder (ECCOS-T)
and the retrieval vote (ECCOS-R) are blended by a retrieval-confidence gate:

    s̄_i  = mean cosine similarity of query i's valid top-k neighbours
    w_i  = sigmoid((s̄_i − tau) / temp)
    cap_i  = w_i · cap^R_i  + (1 − w_i) · cap^T_i
    len_i  = w_i · len^R_i  + (1 − w_i) · len^T_i

The whole predict (encoder heads, featurization, fused retrieval vote,
blend, cost matrix) runs on the device with no host round-trip, so
``OmniRouter`` hands its output straight to the dual solve.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.common import default_device
from repro_torch.data import tokenizer

from .features import FEAT_LEN, predicted_cost, projection
from .predictor import (PredictorConfig, TrainedPredictor,
                        prediction_accuracy, trained_predict_device)
from .retrieval import RetrievalPredictor, retrieval_predict_device


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    d_retrieval: int = 256
    k: int = 8
    feat_seed: int = 7
    tau: float = 0.55            # similarity of equal trust
    temp: float = 0.08           # hand-off sharpness


def hybrid_predict_device(params, store_emb, store_labels, n_valid, proj,
                          tokens, input_len, price_in, price_out, *,
                          pcfg: PredictorConfig, k: int, tau: float,
                          temp: float):
    """ECCOS-H predict on tensors: tokens -> (cap, exp_len, cost, w)."""
    cap_t, len_t, _ = trained_predict_device(
        pcfg, params, tokens, input_len, price_in, price_out)
    cap_r, len_r, _, conf = retrieval_predict_device(
        store_emb, store_labels, n_valid, proj, tokens[:, :FEAT_LEN],
        input_len, price_in, price_out, k=k)
    w = torch.sigmoid((conf - tau) / temp)[:, None]         # (B, 1)
    cap = w * cap_r + (1.0 - w) * cap_t
    exp_len = w * len_r + (1.0 - w) * len_t
    cost = predicted_cost(input_len, exp_len, price_in, price_out)
    return cap, exp_len, cost, w[:, 0]


class HybridPredictor:
    """ECCOS-H = trained heads + vector-store vote behind one contract.

    ``params`` are the encoder's weights (a JAX-layout tree, e.g. from
    ``convert.predictor_params_from_numpy``); without them the encoder is
    initialised from ``seed``.  ``fit`` trains the heads and builds the
    store; ``fit_store`` builds the store alone, for given heads.  The
    store grows with ``observe``, or is handed over as
    ``retrieval.vstore``."""

    def __init__(self, pcfg: Optional[PredictorConfig] = None,
                 hcfg: HybridConfig = HybridConfig(),
                 params: Optional[dict] = None, *, seed: int = 0,
                 device=None):
        self.hcfg = hcfg
        self.device = default_device(device)
        self.trained = TrainedPredictor(pcfg or PredictorConfig(), params,
                                        seed=seed, device=self.device)
        self.retrieval = RetrievalPredictor(
            d=hcfg.d_retrieval, k=hcfg.k, seed=hcfg.feat_seed,
            device=self.device)

    def fit(self, ds, *, steps: int = 300, batch: int = 64, seed: int = 0,
            init: Optional[dict] = None) -> "HybridPredictor":
        """Train the heads (``TrainedPredictor.fit``), then build the
        store from the same dataset."""
        self.trained.fit(ds, steps=steps, batch=batch, seed=seed, init=init)
        self.retrieval.fit(ds)
        return self

    def fit_store(self, ds) -> "HybridPredictor":
        """Build the vector store from a labelled dataset."""
        self.retrieval.fit(ds)
        return self

    def observe(self, texts, correct, out_len) -> "HybridPredictor":
        """Online store growth; the trained heads stay frozen."""
        self.retrieval.observe(texts, correct, out_len)
        return self

    # --- the device predict contract ---------------------------------------
    @property
    def token_len(self) -> int:
        return max(self.trained.cfg.max_len, FEAT_LEN)

    def device_inputs(self):
        vs = self.retrieval.vstore
        return (self.trained.params, vs.emb, vs.labels, vs.n_valid,
                projection(self.hcfg.d_retrieval, self.hcfg.feat_seed,
                           self.device))

    def predict_device(self, inputs, tokens, input_len, price_in, price_out):
        params, emb, labels, n_valid, proj = inputs
        cap, exp_len, cost, _ = hybrid_predict_device(
            params, emb, labels, n_valid, proj, tokens, input_len, price_in,
            price_out, pcfg=self.trained.cfg, k=self.hcfg.k,
            tau=self.hcfg.tau, temp=self.hcfg.temp)
        return cap, exp_len, cost

    def predict_arrays(self, ds):
        """Returns (capability (N,M), expected_out_len (N,M), cost (N,M)) as
        NumPy — the schema of ECCOS-T / ECCOS-R ``predict_arrays``."""
        dev = self.device
        toks = torch.as_tensor(
            tokenizer.encode_batch(ds.queries, self.token_len), device=dev)
        with torch.no_grad():
            out = self.predict_device(
                self.device_inputs(), toks,
                torch.as_tensor(ds.input_len, dtype=torch.float32, device=dev),
                torch.as_tensor(ds.price_in, dtype=torch.float32, device=dev),
                torch.as_tensor(ds.price_out, dtype=torch.float32,
                                device=dev))
        return tuple(t.cpu().numpy() for t in out)

    def eval_accuracy(self, ds) -> Dict[str, float]:
        cap, exp_len, _ = self.predict_arrays(ds)
        return prediction_accuracy(ds, cap, exp_len,
                                   self.trained.cfg.n_buckets)
