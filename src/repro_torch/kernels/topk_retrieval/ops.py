"""Entry points of the fused retrieval, dispatched by device.

A CUDA tensor launches the hand-written kernel (``kernel.py``) or raises;
a CPU tensor runs the plain PyTorch version (``ref.py``); any other device
raises.  The JAX entry points' ``bq``, ``tile`` and ``use_kernel`` (TPU
tiling and a backend switch) have no counterpart: the device decides.
``launches`` counts the vote kernel's launches made through
``retrieval_vote``, ``topk_launches`` the top-k kernel's made through
``topk_retrieval``.
"""
from __future__ import annotations

from .kernel import retrieval_vote_cuda, topk_retrieval_cuda
from .ref import retrieval_vote_ref, topk_retrieval_ref

launches = 0
topk_launches = 0


def topk_retrieval(store, queries, k: int, n_valid=None):
    """Neighbour-only retrieval: (vals (B, k), idx (B, k) int32), ties on
    the lower db index, slots past the valid rows (NEG_INF, -1).  The CPU
    path takes any k; the kernel holds k <= 64 and raises above it."""
    global topk_launches
    if queries.is_cuda:
        out = topk_retrieval_cuda(store, queries, k, n_valid)
        topk_launches += 1
        return out
    if queries.device.type != "cpu":
        raise ValueError(f"no top-k retrieval for device {queries.device}")
    return topk_retrieval_ref(store, queries, k, n_valid)


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
