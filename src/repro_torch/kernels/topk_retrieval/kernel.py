"""Python wrappers of the hand-written CUDA retrieval kernel
(``csrc/retrieval_vote.cu``): similarity → top-k (``topk_retrieval_cuda``)
and similarity → top-k → label vote (``retrieval_vote_cuda``), each one
launch on the current stream.  Both entry points run the same kernel, so
their ``(vals, idx)`` agree bit for bit.  They take CUDA tensors only; the
library builds from the repository's sources at first use.

The kernel's grid is query blocks of ``BQ`` times ``slices`` store slices;
each CTA leaves its slice's sorted list in scratch that the wrapper
allocates, and the last CTA of a query block merges them.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build

KMAX = 64     # top-k slots the kernel holds (paper Table 4: k <= 64)
BQ = 128      # queries per CTA
TN = 128      # store rows per tile; a slice is a run of whole tiles
MIN_SLICE_TILES = 4   # fewer tiles a slice and the folds outweigh the gain
FILL = 0.9    # least share of the CTA slots the grid's waves must fill


@lru_cache(maxsize=1)
def _launcher():
    fn = _build.load("retrieval_vote").retrieval_vote_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=1)
def _topk_launcher():
    fn = _build.load("retrieval_vote").topk_retrieval_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=256)
def slices(b: int, n_rows: int, sms: int) -> int:
    """Store slices of one launch (one CTA an SM: its shared memory holds
    one).  The smallest S whose ``ceil(b / BQ) * S`` CTAs cover every SM
    and fill their waves to ``FILL``; else the S that fills them best.  A
    slice keeps at least ``MIN_SLICE_TILES`` tiles."""
    qb = -(-b // BQ)
    if qb == 0:
        return 1
    cap = max(1, -(-n_rows // TN) // MIN_SLICE_TILES)
    best, best_fill = 1, 0.0
    for s in range(1, cap + 1):
        ctas = qb * s
        fill = ctas / (sms * -(-ctas // sms))
        if ctas >= sms and fill >= FILL:
            return s
        if fill > best_fill:
            best, best_fill = s, fill
    return best


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _outputs(store, queries, k: int, n_valid):
    """(n_valid, slices, vals, idx, scratch) of one launch, on the current
    device."""
    dev = queries.device
    n_db, b = store.shape[0], queries.shape[0]
    nv = n_db if n_valid is None else int(n_valid)
    s = slices(b, min(max(nv, 0), n_db),
               _sm_count(torch.cuda.current_device()))
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    part_v = torch.empty((b, s, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, s, k), dtype=torch.int32, device=dev)
    arrived = torch.zeros(-(-b // BQ), dtype=torch.int32, device=dev)
    return nv, s, vals, idx, (part_v, part_i, arrived)


def topk_retrieval_cuda(store, queries, k: int, n_valid=None):
    """store (N_db, d), queries (B, d), both float32, contiguous and on one
    CUDA device, d a multiple of 4.  Returns (vals (B, k) f32, idx (B, k)
    int32), the contract of ``ref.topk_retrieval_ref``."""
    dev = _check(k, store=store, queries=queries)
    n_db, d = store.shape
    b = queries.shape[0]
    with torch.cuda.device(dev):
        nv, s, vals, idx, scratch = _outputs(store, queries, k, n_valid)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_topk_launcher()(
            store.data_ptr(), queries.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), *(t.data_ptr() for t in scratch), n_db, d, b, k,
            nv, s, stream), "topk_retrieval_launch")
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
    with torch.cuda.device(dev):
        nv, s, vals, idx, scratch = _outputs(store, queries, k, n_valid)
        votes = torch.empty((b, n_lab), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_launcher()(
            store.data_ptr(), labels.data_ptr(), queries.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), votes.data_ptr(),
            *(t.data_ptr() for t in scratch), n_db, d, n_lab, b, k, nv, s,
            stream), "retrieval_vote_launch")
    return vals, idx, votes
