"""Query featurization for the prediction plane (frozen-embedding role).

Hashed bag-of-words → fixed Gaussian random projection → L2 normalize, the
port of ``repro.core.features``.  ``projection_np`` draws the same
``np.random.RandomState(seed).randn`` as the JAX package, so the projection
is bit-identical.  ``featurize_tokens`` sums the projection rows of each
query's tokens with ``embedding_bag`` (per-token weight 0 for PAD/CLS), so
neither the (N, VOCAB) bag-of-words nor the (N, T, d) gathered rows are
ever materialized.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.data import tokenizer

FEAT_LEN = 64          # featurizer token window


@lru_cache(maxsize=8)
def projection_np(d: int = 256, seed: int = 7) -> np.ndarray:
    """(VOCAB, d) Gaussian projection, generated once per (d, seed).  Under
    NumPy 2 the division by ``np.sqrt(d)`` yields float64, as in the JAX
    package; the device copies round it to float32."""
    return np.random.RandomState(seed).randn(
        tokenizer.VOCAB, d).astype(np.float32) / np.sqrt(d)


@lru_cache(maxsize=8)
def _projection(d: int, seed: int, device: str) -> torch.Tensor:
    return torch.from_numpy(projection_np(d, seed)).float().to(device)


def projection(d: int = 256, seed: int = 7, device=None) -> torch.Tensor:
    """Device-resident copy of the cached projection (one per device)."""
    return _projection(d, seed, str(torch.device(
        "cuda" if device is None else device)))


def featurize_tokens(tokens: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """tokens (N, T) int, proj (VOCAB, d) -> L2-normalized (N, d)."""
    mask = (tokens > tokenizer.CLS).to(proj.dtype)           # drop PAD/CLS
    emb = F.embedding_bag(tokens.long(), proj, mode="sum",
                          per_sample_weights=mask)
    norm = torch.linalg.norm(emb, dim=1, keepdim=True)
    return emb / torch.clamp(norm, min=1e-6)


def predicted_cost(input_len, exp_len, price_in, price_out):
    """(N,) input lengths + (N, M) expected output lengths -> (N, M) $ cost
    under per-1k-token pricing (ground-truth twin: ``QAServe.cost_matrix``)."""
    return (input_len[:, None] * price_in[None, :]
            + exp_len * price_out[None, :]) / 1000.0
