"""Python wrappers of the hand-written CUDA split-KV attention
(``csrc/paged_decode.cu``): paged decode (one query position per sequence),
speculative verify (S positions per sequence) and the dense-cache decode
and verify (S >= 1 query positions against a contiguous ``(B, T, K, D)``
cache), each the split pass and the log-sum-exp merge, two launches on the
current stream; and the dense decode's split pass alone, its partials
unmerged (``decode_attention_partials_cuda``, one launch).
They take CUDA tensors only; the library builds from the repository's
sources at first use."""
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


@lru_cache(maxsize=1)
def _dense_launcher():
    fn = _build.load("paged_decode").decode_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=1)
def _partials_launcher():
    fn = _build.load("paged_decode").decode_partials_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k, v, ints, g_max: int):
    """Device, type, contiguity, alignment and head checks shared by the
    three entry points: ``k``/``v`` are the page pools (n_pages, PS, K, D)
    or the dense caches (B, T, K, D), ``ints`` the named int32 tensors.
    Returns (B, S, H, D, K)."""
    dev = q.device
    floats = (("q", q), ("k", k), ("v", v))
    for name, t in floats + ints:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} on {t.device}: all inputs must lie on "
                             "one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype}: bfloat16 or float32 only")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("the K/V pools or caches must have q's dtype")
    if any(t.dtype != torch.int32 for _, t in ints):
        raise ValueError(" and ".join(n for n, _ in ints) + " must be int32")
    if (q.dim() != 4 or k.dim() != 4 or v.shape != k.shape
            or k.shape[3] != q.shape[3]):
        raise ValueError("q must be (B,S,H,D) and the K/V pools or caches "
                         "(.., .., K, D) of q's head dim")
    b, s, h, d = q.shape
    kh = k.shape[2]
    if h % kh or s * (h // kh) > g_max:
        raise ValueError(f"H={h} must be a multiple of K={kh}, with S={s} "
                         f"positions x {h // max(kh, 1)} query heads per kv "
                         f"head at most {g_max} rows")
    vec = 16 // q.element_size()
    if d > DMAX or d % vec:
        raise ValueError(f"head dim {d} must be a multiple of {vec} and at "
                         f"most {DMAX}")
    for name, t in floats:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return b, s, h, d, kh


def _check_paged(q, k_pages, v_pages, block_table, lens, g_max: int):
    """The shared checks plus the block table's; returns (B, S, H, D, PS,
    K, P)."""
    b, s, h, d, kh = _check_inputs(
        q, k_pages, v_pages, (("block_table", block_table), ("lens", lens)),
        g_max)
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or tuple(lens.shape) != (b,):
        raise ValueError("block_table must be (B,P) and lens (B,)")
    ps = k_pages.shape[1]
    if not 1 <= ps <= SPLIT_POS:
        raise ValueError(f"page size {ps} must be in 1..{SPLIT_POS}")
    return b, s, h, d, ps, kh, block_table.shape[1]


def paged_verify_attention_cuda(q, k_pages, v_pages, block_table, lens, *,
                                window: int = 0):
    """q (B,S,H,D); pools (n_pages, PS, K, D) of q's dtype (bfloat16 or
    float32); block_table (B,P) int32; lens (B,) int32 valid lengths of
    query 0: query s attends to positions < lens[b] + s (and >= lens[b] + s
    - window with a window).  S·H/K at most 64.  Returns (B,S,H,D) in q's
    dtype, the contract of ``ref.paged_verify_attention_ref``; row s equals
    ``paged_decode_attention_cuda`` at lens + s bit for bit."""
    b, s, h, d, ps, kh, p = _check_paged(q, k_pages, v_pages, block_table,
                                         lens, RMAX_VERIFY)
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
    b, s, h, d, ps, kh, p = _check_paged(q, k_pages, v_pages, block_table,
                                         lens, GMAX)
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


def decode_attention_cuda(q, k_cache, v_cache, lens, *, window: int = 0):
    """q (B,S,H,D); caches (B,T,K,D) of q's dtype (bfloat16 or float32),
    contiguous, any T; lens (B,) int32 valid lengths of query 0: query s of
    sequence b attends to position t when t < lens[b] + s (clamped to
    [0, T]; and t >= lens[b] + s - window with a window).  S = 1 is the
    decode (H/K at most 8), S > 1 the verify (S·H/K at most 64).  Returns
    (B,S,H,D) in q's dtype, the contract of ``ref.decode_attention_ref``
    (S = 1) and ``ref.verify_attention_ref`` on every row with at least one
    valid position; equal bit for bit to ``paged_decode_attention_cuda``
    over the same rows laid out as pages, and row s to the decode at
    lens + s."""
    one = q.dim() != 4 or q.shape[1] == 1
    b, s, h, d, kh = _check_inputs(q, k_cache, v_cache, (("lens", lens),),
                                   GMAX if one else RMAX_VERIFY)
    t = k_cache.shape[1]
    if k_cache.shape[0] != b or t < 1 or tuple(lens.shape) != (b,):
        raise ValueError("the caches must be (B,T,K,D) with T >= 1 and lens "
                         "(B,)")
    dev = q.device
    n_splits = -(-t // SPLIT_POS)
    rows = s * (h // kh)
    o_part = torch.empty((b, kh, n_splits, rows, d), dtype=torch.float32,
                         device=dev)
    m_part = torch.empty((b, kh, n_splits, rows), dtype=torch.float32,
                         device=dev)
    l_part = torch.empty_like(m_part)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_dense_launcher()(
            _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lens.data_ptr(), o_part.data_ptr(),
            m_part.data_ptr(), l_part.data_ptr(), out.data_ptr(), b, s, h,
            kh, d, t, int(window), d ** -0.5, n_splits, stream),
            "decode_launch")
    return out


def decode_attention_partials_cuda(q, k_cache, v_cache, lens):
    """The dense decode's split pass alone: q (B,1,H,D); caches (B,T,K,D)
    of q's dtype (bfloat16 or float32), contiguous; lens (B,) int32 valid
    lengths (0 allowed).  Returns the unmerged partials of splits of
    ``SPLIT_POS`` positions in the reference kernel's layout, float32: o
    (B,K,n_splits,G,D) the unnormalised numerators, m and l
    (B,K,n_splits,G) the score max and the exp sum; a split with no valid
    position gives (0, -1e30, 0).  ``ref.decode_attention_partials_ref``
    is its plain version; ``ops.merge_partials`` of them is
    ``decode_attention_cuda``'s result before its rounding to q's type."""
    b, s, h, d, kh = _check_inputs(q, k_cache, v_cache, (("lens", lens),),
                                   GMAX)
    t = k_cache.shape[1]
    if s != 1 or k_cache.shape[0] != b or tuple(lens.shape) != (b,):
        raise ValueError("q must be (B,1,H,D), the caches (B,T,K,D) and "
                         "lens (B,)")
    dev = q.device
    n_splits = -(-t // SPLIT_POS)
    g = h // kh
    o_part = torch.empty((b, kh, n_splits, g, d), dtype=torch.float32,
                         device=dev)
    m_part = torch.empty((b, kh, n_splits, g), dtype=torch.float32,
                         device=dev)
    l_part = torch.empty_like(m_part)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_partials_launcher()(
            _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lens.data_ptr(), o_part.data_ptr(),
            m_part.data_ptr(), l_part.data_ptr(), b, h, kh, d, t, d ** -0.5,
            n_splits, stream),
            "decode_partials_launch")
    return o_part, m_part, l_part
