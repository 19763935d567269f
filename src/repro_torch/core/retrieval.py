"""ECCOS-R: retrieval-based predictor (paper §3.1, Eq. 5).

The port of ``repro.core.retrieval``.  Historical queries live in a
:class:`VectorStore`, a device-resident (capacity, d) embedding buffer plus a
(capacity, 2M) label buffer [correctness per model ‖ output length per
model].  For a new query the top-k cosine neighbours vote: predicted
capability and output length are the neighbour means per model.  The predict
path stays on the device: tokens → hashed-BoW embedding → fused similarity →
top-k → label vote (``kernels.topk_retrieval.ops.retrieval_vote``: the CUDA
kernel on the card) → cost matrix.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.common import default_device
from repro_torch.data import tokenizer

from .features import FEAT_LEN, featurize_tokens, predicted_cost, projection
from .predictor import prediction_accuracy


class VectorStore:
    """Incremental device-resident vector store (embeddings + labels).

    ``append`` writes the new rows into the buffers in place on the device;
    capacity doubles geometrically, so N appends cost O(log N)
    reallocations.  ``n_valid`` (the live row count) goes to the retrieval
    kernel as a runtime value.  ``compact`` trims the buffers back to a
    128-row-aligned envelope of the live rows.
    """

    def __init__(self, d: int, n_labels: int, capacity: int = 1024,
                 device=None):
        self.size = 0
        self.device = default_device(device)
        cap = max(capacity, 8)
        self.emb = torch.zeros((cap, d), device=self.device)
        self.labels = torch.zeros((cap, n_labels), device=self.device)

    @property
    def capacity(self) -> int:
        return self.emb.shape[0]

    @property
    def n_valid(self) -> int:
        """Live row count — the retrieval kernel's ``n_valid``."""
        return self.size

    def _grow(self, cap: int):
        cap = max(cap, 8)
        emb = torch.zeros((cap, self.emb.shape[1]), device=self.device)
        labels = torch.zeros((cap, self.labels.shape[1]), device=self.device)
        emb[:self.size] = self.emb[:self.size]
        labels[:self.size] = self.labels[:self.size]
        self.emb, self.labels = emb, labels

    def append(self, emb, labels) -> "VectorStore":
        emb = torch.as_tensor(emb, dtype=torch.float32, device=self.device)
        labels = torch.as_tensor(labels, dtype=torch.float32,
                                 device=self.device)
        n = emb.shape[0]
        if self.size + n > self.capacity:
            cap = self.capacity
            while cap < self.size + n:
                cap *= 2
            self._grow(cap)
        self.emb[self.size:self.size + n] = emb
        self.labels[self.size:self.size + n] = labels
        self.size += n
        return self

    def compact(self) -> "VectorStore":
        self._grow(-(-max(self.size, 1) // 128) * 128)
        return self


def retrieval_predict_device(store_emb, store_labels, n_valid, proj, tokens,
                             input_len, price_in, price_out, *, k: int):
    """ECCOS-R predict on tensors: tokens -> (cap, exp_len, cost, conf).

    ``conf`` is the mean cosine similarity of the valid neighbours — the
    retrieval-confidence signal the hybrid blend consumes."""
    from repro_torch.kernels.topk_retrieval.ops import retrieval_vote

    q = featurize_tokens(tokens, proj)
    vals, idx, votes = retrieval_vote(store_emb, store_labels, q, k,
                                      n_valid=n_valid)
    m = price_in.shape[0]
    cap, exp_len = votes[:, :m], votes[:, m:]
    cost = predicted_cost(input_len, exp_len, price_in, price_out)
    valid = idx >= 0
    conf = (torch.where(valid, vals, 0.0).sum(1)
            / torch.clamp(valid.float().sum(1), min=1.0))
    return cap, exp_len, cost, conf


def cosine_topk(store, queries, k: int = 8):
    """store (N_db, d) L2-normalized; queries (B, d).  Returns (vals, idx).

    The plain two-op path (matmul + sort), kept as the unfused baseline:
    ``topk_retrieval_ref`` on every device.  k is clamped to the store size
    and the clamped slots return (NEG_INF, -1), like the fused paths."""
    from repro_torch.kernels.topk_retrieval.ref import topk_retrieval_ref

    return topk_retrieval_ref(store, queries, k)


class RetrievalPredictor:
    """ECCOS-R over a :class:`VectorStore`, fully device-resident."""

    def __init__(self, d: int = 256, k: int = 8, seed: int = 7, device=None):
        self.d = d
        self.k = k
        self.seed = seed
        self.device = default_device(device)
        self.vstore: Optional[VectorStore] = None
        self.pool = None

    # --- store construction / online growth -------------------------------
    def embed_texts(self, texts) -> torch.Tensor:
        toks = torch.as_tensor(tokenizer.encode_batch(texts, FEAT_LEN),
                               device=self.device)
        return featurize_tokens(toks, projection(self.d, self.seed,
                                                 self.device))

    def fit(self, ds):
        self.pool = ds.pool
        self.vstore = VectorStore(self.d, 2 * ds.m, capacity=max(1024, ds.n),
                                  device=self.device)
        self.observe(ds.queries, ds.correct, ds.out_len)
        return self

    def observe(self, texts, correct, out_len) -> "RetrievalPredictor":
        """Fold completed requests back into the store online."""
        labels = np.concatenate([np.asarray(correct, np.float32),
                                 np.asarray(out_len, np.float32)], axis=1)
        self.vstore.append(self.embed_texts(texts), labels)
        return self

    # --- the device predict contract (shared with Trained/Hybrid) ---------
    @property
    def token_len(self) -> int:
        return FEAT_LEN

    def device_inputs(self):
        vs = self.vstore
        return (vs.emb, vs.labels, vs.n_valid,
                projection(self.d, self.seed, self.device))

    def predict_device(self, inputs, tokens, input_len, price_in, price_out):
        emb, labels, n_valid, proj = inputs
        cap, exp_len, cost, _ = retrieval_predict_device(
            emb, labels, n_valid, proj, tokens, input_len, price_in,
            price_out, k=self.k)
        return cap, exp_len, cost

    def predict_arrays(self, ds):
        """Returns (capability (N,M), expected_out_len (N,M), cost (N,M)) as
        NumPy for anything exposing the RouteBatch feature surface."""
        dev = self.device
        toks = torch.as_tensor(tokenizer.encode_batch(ds.queries, FEAT_LEN),
                               device=dev)
        out = self.predict_device(
            self.device_inputs(), toks,
            torch.as_tensor(ds.input_len, dtype=torch.float32, device=dev),
            torch.as_tensor(ds.price_in, dtype=torch.float32, device=dev),
            torch.as_tensor(ds.price_out, dtype=torch.float32, device=dev))
        return tuple(t.cpu().numpy() for t in out)

    def eval_accuracy(self, ds, n_buckets: int = 10) -> Dict[str, float]:
        cap, exp_len, _ = self.predict_arrays(ds)
        return prediction_accuracy(ds, cap, exp_len, n_buckets)
