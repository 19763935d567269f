"""Plain versions of the fused similarity → top-k (→ label vote).

- ``topk_retrieval_ref`` — plain PyTorch with the kernels' contract: rows
  at or past ``n_valid`` are masked to ``NEG_INF``; ``k`` greater than the
  valid rows leaves ``(NEG_INF, -1)`` slots; ties go to the lower db index
  (a stable descending sort).  It is the CPU path of ``ops.topk_retrieval``
  and the yardstick the CUDA kernel is held against on the card.  The
  similarity is a float32 ``matmul`` (on CUDA,
  ``torch.backends.cuda.matmul.allow_tf32`` must stay False, its default).
- ``retrieval_vote_ref`` — ``topk_retrieval_ref`` plus the vote: the mean
  label over the valid neighbours only, so the two give the same
  ``(vals, idx)`` by construction.  The CPU path of ``ops.retrieval_vote``.
- ``retrieval_vote_oracle`` — NumPy ground truth, a copy of the JAX
  package's.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30

# query rows per similarity block: bounds the plain version's (rows, N_db)
# similarity matrix and its sort (1024 x 131072 fp32 = 512 MiB)
_CHUNK = 1024


def _topk_block(store, queries, k: int, nv: int):
    b = queries.shape[0]
    k_eff = min(k, nv)
    sims = queries.float() @ store[:nv].float().T             # (b, nv)
    vals, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k_eff], idx[:, :k_eff].to(torch.int32)
    pad = k - k_eff
    vals = torch.cat([vals, vals.new_full((b, pad), NEG_INF)], dim=1)
    idx = torch.cat([idx, idx.new_full((b, pad), -1)], dim=1)
    return vals, idx


def _live_rows(store, n_valid) -> int:
    return store.shape[0] if n_valid is None else min(int(n_valid),
                                                      store.shape[0])


def topk_retrieval_ref(store, queries, k: int, n_valid=None):
    """store (N_db, d), queries (B, d) -> (vals (B, k) f32, idx (B, k)
    int32).  Only the first ``n_valid`` store rows (default all) are
    candidates, so every query has ``min(k, n_valid)`` neighbours; any k
    is taken."""
    nv = _live_rows(store, n_valid)
    parts = [_topk_block(store, queries[i:i + _CHUNK], k, nv)
             for i in range(0, queries.shape[0], _CHUNK)]
    if not parts:
        return (queries.new_empty((0, k)),
                torch.empty((0, k), dtype=torch.int32, device=queries.device))
    return tuple(torch.cat(p, dim=0) for p in zip(*parts))


def retrieval_vote_ref(store, labels, queries, k: int, n_valid=None):
    """store (N_db, d), labels (N_db, L), queries (B, d) -> (vals (B, k)
    f32, idx (B, k) int32, votes (B, L) f32): ``topk_retrieval_ref`` and
    the mean label of the ``min(k, n_valid)`` neighbours."""
    vals, idx = topk_retrieval_ref(store, queries, k, n_valid)
    k_eff = min(k, _live_rows(store, n_valid))
    # neighbour labels summed in slot order, as the kernel sums them
    votes = torch.zeros((queries.shape[0], labels.shape[1]),
                        device=queries.device)
    for s in range(k_eff):
        votes = votes + labels[idx[:, s].long()].float()
    # a tensor divisor: PyTorch's CUDA division by a Python number
    # multiplies by its reciprocal, where the kernel divides
    votes = votes / torch.tensor(float(max(k_eff, 1)), device=votes.device)
    return vals, idx, votes


def retrieval_vote_oracle(store, labels, queries, k: int, n_valid=None):
    """NumPy ground truth (stable sort ⇒ ties break to the lower db index)."""
    store = np.asarray(store, np.float32)
    labels = np.asarray(labels, np.float32)
    queries = np.asarray(queries, np.float32)
    nv = store.shape[0] if n_valid is None else int(n_valid)
    b = queries.shape[0]
    k_eff = min(k, nv)

    sims = queries @ store[:nv].T                            # (B, nv)
    order = np.argsort(-sims, axis=1, kind="stable")[:, :k_eff]
    vals = np.take_along_axis(sims, order, axis=1)

    votes = labels[order].mean(axis=1) if k_eff else np.zeros(
        (b, labels.shape[1]), np.float32)
    pad = k - k_eff
    vals = np.concatenate([vals, np.full((b, pad), NEG_INF, np.float32)], 1)
    idx = np.concatenate([order, np.full((b, pad), -1)], 1).astype(np.int32)
    return vals, idx, votes.astype(np.float32)
