"""Entry point of the fused retrieval vote, dispatched by device.

A CUDA tensor launches the hand-written kernel (``kernel.py``) or raises;
a CPU tensor runs the plain PyTorch version (``ref.py``).  ``launches``
counts the kernel launches made through this entry point.
"""
from __future__ import annotations

from .kernel import retrieval_vote_cuda
from .ref import retrieval_vote_ref

launches = 0


def retrieval_vote(store, labels, queries, k: int, n_valid=None):
    """Fused sim → top-k → gather-labels → neighbour-mean vote.  Returns
    (vals (B, k), idx (B, k) int32, votes (B, L)); votes average over the
    valid neighbours only, and slots past the valid rows are (NEG_INF, -1).
    """
    global launches
    if queries.is_cuda:
        out = retrieval_vote_cuda(store, labels, queries, k, n_valid)
        launches += 1
        return out
    if queries.device.type != "cpu":
        raise ValueError(f"no retrieval vote for device {queries.device}")
    return retrieval_vote_ref(store, labels, queries, k, n_valid)
