"""Python wrappers of the hand-written CUDA paged attention
(``csrc/paged_decode.cu``): decode (one query position per sequence) and
speculative verify (S positions per sequence), each the split pass and the
log-sum-exp merge, two launches on the current stream.  They take CUDA
tensors only; the library builds from the repository's sources at first
use."""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build

SPLIT_POS = 256    # positions one CTA covers at most
GMAX = 8           # query heads per kv head
RMAX_VERIFY = 64   # verify rows (positions x query heads per kv head)
DMAX = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@lru_cache(maxsize=1)
def _launcher():
    fn = _build.load("paged_decode").paged_decode_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 7 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=1)
def _verify_launcher():
    fn = _build.load("paged_decode").paged_verify_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 8 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k_pages, v_pages, block_table, lens, g_max: int):
    """Device, type, shape, contiguity and alignment checks shared by both
    entry points; returns (B, S, H, D, n_pages, PS, K, P)."""
    dev = q.device
    tensors = (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
               ("block_table", block_table), ("lens", lens))
    for name, t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} on {t.device}: all five must lie on "
                             "one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype}: bfloat16 or float32 only")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("the page pools must have q's dtype")
    if block_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("block_table and lens must be int32")
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("q must be (B,S,H,D) and the pools (n_pages,PS,K,D)")
    b, s, h, d = q.shape
    n_pages, ps, kh, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError("k_pages/v_pages/q shapes disagree")
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or tuple(lens.shape) != (b,):
        raise ValueError("block_table must be (B,P) and lens (B,)")
    if h % kh or s * (h // kh) > g_max:
        raise ValueError(f"H={h} must be a multiple of K={kh}, with S={s} "
                         f"positions x {h // max(kh, 1)} query heads per kv "
                         f"head at most {g_max} rows")
    vec = 16 // q.element_size()
    if d > DMAX or d % vec:
        raise ValueError(f"head dim {d} must be a multiple of {vec} and at "
                         f"most {DMAX}")
    if not 1 <= ps <= SPLIT_POS:
        raise ValueError(f"page size {ps} must be in 1..{SPLIT_POS}")
    for name, t in tensors[:3]:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return b, s, h, d, n_pages, ps, kh, block_table.shape[1]


def paged_verify_attention_cuda(q, k_pages, v_pages, block_table, lens, *,
                                window: int = 0):
    """q (B,S,H,D); pools (n_pages, PS, K, D) of q's dtype (bfloat16 or
    float32); block_table (B,P) int32; lens (B,) int32 valid lengths of
    query 0: query s attends to positions < lens[b] + s (and >= lens[b] + s
    - window with a window).  S·H/K at most 64.  Returns (B,S,H,D) in q's
    dtype, the contract of ``ref.paged_verify_attention_ref``; row s equals
    ``paged_decode_attention_cuda`` at lens + s bit for bit."""
    b, s, h, d, _, ps, kh, p = _check_inputs(q, k_pages, v_pages,
                                             block_table, lens, RMAX_VERIFY)
    dev = q.device
    pps = SPLIT_POS // ps                      # pages per split
    n_splits = -(-p // pps)
    rows = s * (h // kh)
    o_part = torch.empty((b, kh, n_splits, rows, d), dtype=torch.float32,
                         device=dev)
    m_part = torch.empty((b, kh, n_splits, rows), dtype=torch.float32,
                         device=dev)
    l_part = torch.empty_like(m_part)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_verify_launcher()(
            _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_table.data_ptr(), lens.data_ptr(),
            o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            out.data_ptr(), b, s, h, kh, d, ps, p, int(window), d ** -0.5,
            pps, n_splits, stream), "paged_verify_launch")
    return out


def paged_decode_attention_cuda(q, k_pages, v_pages, block_table, lens, *,
                                window: int = 0):
    """q (B,1,H,D); pools (n_pages, PS, K, D) of q's dtype (bfloat16 or
    float32); block_table (B,P) int32 physical page ids in [0, n_pages);
    lens (B,) int32 valid lengths (clamped to [0, P·PS]).  Returns
    (B,1,H,D) in q's dtype, the contract of ``ref.paged_decode_attention_ref``
    on every sequence with at least one valid position."""
    b, s, h, d, _, ps, kh, p = _check_inputs(q, k_pages, v_pages,
                                             block_table, lens, GMAX)
    if s != 1:
        raise ValueError("q must be (B,1,H,D)")
    dev = q.device
    pps = SPLIT_POS // ps                      # pages per split
    n_splits = -(-p // pps)
    g = h // kh
    o_part = torch.empty((b, kh, n_splits, g, d), dtype=torch.float32,
                         device=dev)
    m_part = torch.empty((b, kh, n_splits, g), dtype=torch.float32,
                         device=dev)
    l_part = torch.empty_like(m_part)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_launcher()(
            _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_table.data_ptr(), lens.data_ptr(),
            o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            out.data_ptr(), b, h, kh, d, ps, p, int(window), d ** -0.5, pps,
            n_splits, stream), "paged_decode_launch")
    return out
