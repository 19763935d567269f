"""Python wrappers of the hand-written CUDA retrieval kernel
(``csrc/retrieval_vote.cu``): similarity → top-k (``topk_retrieval_cuda``)
and similarity → top-k → label vote (``retrieval_vote_cuda``), each one
launch on the current stream.  Both entry points run the same CTA and fold,
so their ``(vals, idx)`` agree bit for bit.  They take CUDA tensors only;
the library builds from the repository's sources at first use.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build

KMAX = 64     # top-k slots the kernel holds (paper Table 4: k <= 64)


@lru_cache(maxsize=1)
def _launcher():
    fn = _build.load("retrieval_vote").retrieval_vote_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=1)
def _topk_launcher():
    fn = _build.load("retrieval_vote").topk_retrieval_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(k: int, **tensors):
    """One CUDA device, 2-D float32, contiguous and 16-byte aligned, the
    embedding width a multiple of 4, 1 <= k <= KMAX."""
    dev = tensors["queries"].device
    for name, t in tensors.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} on {t.device}: all must lie on one "
                             "CUDA device")
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D float32 tensor")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    d = tensors["store"].shape[1]
    if tensors["queries"].shape[1] != d:
        raise ValueError("store/queries widths disagree")
    if d % 4:
        raise ValueError(f"embedding width {d} must be a multiple of 4")
    if not 1 <= k <= KMAX:
        raise ValueError(f"k must be in 1..{KMAX}, got {k}")
    return dev


def topk_retrieval_cuda(store, queries, k: int, n_valid=None):
    """store (N_db, d), queries (B, d), both float32, contiguous and on one
    CUDA device, d a multiple of 4.  Returns (vals (B, k) f32, idx (B, k)
    int32), the contract of ``ref.topk_retrieval_ref``."""
    dev = _check(k, store=store, queries=queries)
    n_db, d = store.shape
    b = queries.shape[0]
    nv = n_db if n_valid is None else int(n_valid)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_topk_launcher()(
            store.data_ptr(), queries.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), n_db, d, b, k, nv, stream),
            "topk_retrieval_launch")
    return vals, idx


def retrieval_vote_cuda(store, labels, queries, k: int, n_valid=None):
    """store (N_db, d), labels (N_db, L), queries (B, d), all float32,
    contiguous and on one CUDA device, d a multiple of 4.  Returns
    (vals (B, k) f32, idx (B, k) int32, votes (B, L) f32), the contract of
    ``ref.retrieval_vote_ref``."""
    dev = _check(k, store=store, labels=labels, queries=queries)
    n_db, d = store.shape
    b, n_lab = queries.shape[0], labels.shape[1]
    if labels.shape[0] != n_db:
        raise ValueError("store/labels rows disagree")
    nv = n_db if n_valid is None else int(n_valid)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    votes = torch.empty((b, n_lab), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_launcher()(
            store.data_ptr(), labels.data_ptr(), queries.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), votes.data_ptr(), n_db, d,
            n_lab, b, k, nv, stream), "retrieval_vote_launch")
    return vals, idx, votes
