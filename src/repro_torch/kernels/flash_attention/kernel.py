"""Python wrappers of the hand-written CUDA flash attention: the forward
(``csrc/flash_attention.cu``, one launch on the current stream, bfloat16 on
the tensor cores and float32 on the CUDA cores, optionally writing each
row's log-sum-exp) and its backward (``csrc/flash_attention_bwd.cu``, two
launches: dQ with Delta, then dK and dV; ``bwd_schedule`` says what each of
their CTAs walks on the tensor cores).  They take CUDA tensors only; the
libraries build from the repository's sources at first use."""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build

MAX_SMEM = 232_448       # dynamic shared memory one CTA may use (H100)
# bfloat16: the tensor-core kernel, 8 warps of 16 rows, K/V tiles of 64
# positions (one online-softmax step each), two buffers of each
TC_ROWS = 128
TC_BK = 64
# float32: the CUDA-core kernel, 512 threads, K/V tiles of 64 positions run
# as two softmax steps of 32; head dim -> (rows per warp, head dims per
# lane / 32) of the kernel instance
THREADS = 512
BK = 64
HALF = 32
INSTANCES = {16: (16, 1), 64: (16, 2), 96: (16, 3), 120: (16, 4),
             128: (16, 4), 256: (8, 8)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# the backward on the CUDA cores (float32; bf16 at d 256): 8 warps of 8
# rows (dQ) or key positions (dK, dV), 64 a CTA; key tiles of 32 positions
# (dQ), query-row tiles of 32 (dK, dV)
BWD_ROWS = 64
BWD_BK = 32
BWD_QT = 32
# the backward on the tensor cores (bf16, d <= 128): a producer warp (in a
# warpgroup of its own) and BWD_CONS consumer warpgroups; dQ's consumers
# each own BWD_TILE query rows, dK/dV's share BWD_TILE keys (one forms dV,
# the other dK); streamed tiles of BWD_TILE rows through BWD_STAGES ring
# stages; panels of 64 rows x 64 bf16; a query tile's lse and Delta, 2 x
# BWD_TILE floats; dK/dV hands a float32 P^T tile (BWD_XBUF bytes, two
# buffers) from one consumer to the other; tile classes of
# ``bwd_tile_class``
BWD_TILE = 64
BWD_CONS = 2
BWD_STAGES = 2
BWD_PANEL = 64 * 64 * 2
BWD_AUX = 2 * BWD_TILE
BWD_XBUF = BWD_TILE * BWD_TILE * 4
EMPTY, PARTIAL, FULL = 0, 1, 2


@lru_cache(maxsize=1)
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 9 + [ctypes.c_float]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=1)
def _bwd_launcher():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 9 + [ctypes.c_float]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _rows(d: int, dtype) -> int:
    """Rows (query position x head) of one CTA."""
    if dtype == torch.bfloat16:
        return TC_ROWS
    return (THREADS // 32) * INSTANCES[d][0]


def softmax_step(d: int, dtype) -> int:
    """Key positions per online-softmax update at head dim ``d``, aligned
    to multiples of it: the kernel rounds p to the operand type at the
    same points as ``flash_attention_chunked(kv_chunk=softmax_step(...))``
    over keys padded to a multiple of it."""
    if d not in INSTANCES:
        raise ValueError(f"head dim {d}: the kernel takes {sorted(INSTANCES)}")
    return TC_BK if dtype == torch.bfloat16 else HALF


def smem_bytes(d: int, dtype) -> int:
    """Dynamic shared memory of one CTA at head dim ``d``.  bfloat16: the
    scaled Q block (128 rows) and two K and two V tiles (64 positions), the
    rows D rounded up to 16 plus 8 elements (an odd number of 16-byte
    units); float32: the p buffer (R x 32), the scaled Q block (R x D) and
    the K and V tiles (64 x D, the row padded to an odd number of 16-byte
    units)."""
    if dtype == torch.bfloat16:
        stride = -(-d // 16) * 16 + 8
        return 2 * stride * (TC_ROWS + 4 * TC_BK)
    rows = _rows(d, dtype)
    units = d * 4 // 16
    units += 1 - units % 2
    return 4 * rows * HALF + 4 * rows * d + 2 * BK * units * 16


def _bwd_tc(d: int, dtype) -> bool:
    """The backward runs on the tensor cores: bf16 at d <= 128."""
    return dtype == torch.bfloat16 and d <= 128


def bwd_smem_bytes(d: int, dtype) -> int:
    """Dynamic shared memory of the larger of the backward's two CTAs at
    head dim ``d``.  Tensor cores (bf16, d <= 128; panels of 64 x 64 bf16,
    ceil(d / 64) a row): dQ holds each consumer's scaled-Q and dO panels
    and BWD_STAGES stages of K and V panels, dK/dV the unit's K and V
    panels, BWD_STAGES stages of scaled-Q and dO panels with the tile's lse
    and Delta, and two float32 P^T tiles; a full and an empty mbarrier (8
    bytes each) a stage, dK/dV two more for its K and V, and 1024 bytes to
    align the panels.  CUDA
    cores: dQ holds 64 scaled Q and dO rows, a K and a V tile of 32
    positions and a float32 dS buffer (64 x 32); dK/dV holds 64 K and V
    rows, a tile of 32 scaled Q and dO rows, float32 P and dS buffers (64 x
    32) and the tile's lse and Delta, rows padded to an odd number of
    16-byte units."""
    if _bwd_tc(d, dtype):
        chunks = -(-d // 64)
        dq = (BWD_PANEL * chunks * (2 * BWD_CONS + 2 * BWD_STAGES)
              + 16 * BWD_STAGES + 1024)
        dkv = (BWD_PANEL * chunks * (2 + 2 * BWD_STAGES) + 2 * BWD_XBUF
               + 4 * BWD_AUX * BWD_STAGES + 16 * BWD_STAGES + 16 + 1024)
        return max(dq, dkv)
    elem = 2 if dtype == torch.bfloat16 else 4
    units = d * elem // 16
    units += 1 - units % 2
    row = units * 16
    dq = 4 * BWD_ROWS * BWD_BK + row * (2 * BWD_ROWS + 2 * BWD_BK)
    dkv = row * (2 * BWD_ROWS + 2 * BWD_QT) + 4 * (2 * BWD_ROWS * BWD_QT
                                                    + 2 * BWD_QT)
    return max(dq, dkv)


def bwd_tile_class(p_lo: int, p_hi: int, t_lo: int, skv: int, causal: bool,
                   window: int) -> int:
    """The tensor-core backward's class of a tile: real query positions
    [p_lo, p_hi] (``q_offset`` added) against the BWD_TILE keys from
    ``t_lo``.  EMPTY (no visible pair: skipped), FULL (every pair visible
    and every key below ``skv``: no mask) or PARTIAL (masked per element).
    The kernel's ``tile_class`` is this function."""
    t_hi = t_lo + BWD_TILE - 1
    te = min(t_hi, skv - 1)
    if p_hi < p_lo or t_lo > te:
        return EMPTY
    if causal and t_lo > p_hi:
        return EMPTY
    if window > 0 and te <= p_lo - window:
        return EMPTY
    if (t_hi < skv and (not causal or t_hi <= p_lo)
            and (window <= 0 or t_lo > p_hi - window)):
        return FULL
    return PARTIAL


def bwd_schedule(sq: int, skv: int, g: int, causal: bool, window: int = 0,
                 q_offset: int = 0) -> dict:
    """What each CTA of the tensor-core backward walks, for one (sequence,
    kv head); the kernels compute the same (``dq_range``, ``dkv_range``).

    dQ unit u owns the query positions from u x BWD_CONS x BQ (consumer w
    the BQ = BWD_TILE // g positions from (u x BWD_CONS + w) x BQ, all g
    heads of each); dK/dV unit u the BWD_TILE keys from u x BWD_TILE (both
    consumers: one forms dV, the other dK).
    CTA x takes units x and n-1-x, so under a causal mask a long unit and
    a short one share a CTA.  Returns {"dq": [...], "dkv": [...], "bq":
    BQ}: per CTA a list of (unit, first, count), the streamed tiles the
    unit walks: key tiles of BWD_TILE from key ``first`` (dQ), query tiles
    of BQ positions from position ``first`` (dK/dV)."""
    bq = BWD_TILE // g
    out = {"bq": bq}
    for kind, units in (("dq", -(-sq // (BWD_CONS * bq))),
                        ("dkv", -(-skv // BWD_TILE))):
        ctas = []
        for x in range(-(-units // 2)):
            walk = []
            for u in sorted({x, units - 1 - x}):
                if kind == "dq":
                    p_lo = q_offset + u * BWD_CONS * bq
                    p_hi = q_offset + min((u + 1) * BWD_CONS * bq, sq) - 1
                    hi = min(skv, p_hi + 1) if causal else skv
                    lo = max(0, p_lo - window + 1) if window > 0 else 0
                    first = lo // BWD_TILE * BWD_TILE
                    n = -(-(hi - first) // BWD_TILE) if lo < hi else 0
                else:
                    t_lo = u * BWD_TILE
                    t_hi = min(t_lo + BWD_TILE, skv) - 1
                    lo = max(0, t_lo - q_offset) if causal else 0
                    hi = (min(sq, t_hi + window - q_offset) if window > 0
                          else sq)
                    first = lo // bq * bq
                    n = -(-(hi - first) // bq) if lo < hi else 0
                walk.append((u, first, n))
            ctas.append(walk)
        out[kind] = ctas
    return out


def query_block(h: int, kh: int, d: int, dtype) -> int:
    """Query positions per CTA: the rows over the group size."""
    return _rows(d, dtype) // (h // kh)


def _check_tensors(dev, named):
    for name, t in named:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} on {t.device}: the tensors must lie "
                             "on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention_cuda(q, k, v, *, causal: bool, window: int = 0,
                         q_offset: int = 0, with_lse: bool = False):
    """q (B,Sq,H,D); k/v (B,Skv,K,D) of q's dtype (bfloat16 or float32),
    contiguous, any Sq and Skv; D in {16, 64, 96, 120, 128, 256}.  Query row i
    sits at position ``q_offset + i``.  Returns (B,Sq,H,D) in q's dtype, the
    contract of ``ref.flash_attention_chunked`` on every row with at least
    one visible position; with ``with_lse``, (out, lse) with lse float32
    (B,H,Sq) each row's log-sum-exp (-inf where no position is visible),
    from the same launch."""
    dev = q.device
    _check_tensors(dev, (("q", q), ("k", k), ("v", v)))
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype}: bfloat16 or float32 only")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("k and v must have q's dtype")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be (B,Sq,H,D) and k, v (B,Skv,K,D)")
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or sq < 1 or skv < 1:
        raise ValueError("q/k/v shapes disagree")
    if h % kh:
        raise ValueError(f"H={h} must be a multiple of K={kh}")
    if d not in INSTANCES:
        raise ValueError(f"head dim {d}: the kernel takes {sorted(INSTANCES)}")
    if query_block(h, kh, d, q.dtype) < 1:
        raise ValueError(f"{h // kh} query heads per kv head exceed one CTA")
    smem = smem_bytes(d, q.dtype)
    if smem > MAX_SMEM:
        raise ValueError(f"head dim {d} in {q.dtype} needs {smem} bytes of "
                         f"shared memory, above {MAX_SMEM}")
    if q_offset < 0:
        raise ValueError("q_offset must be >= 0")
    scale_q = float(torch.tensor(d ** -0.5, dtype=q.dtype))
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_launcher()(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), b, sq,
            skv, h, kh, d, int(bool(causal)), int(window), int(q_offset),
            scale_q, stream),
            "flash_attention_launch")
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *, causal: bool,
                             window: int = 0, q_offset: int = 0):
    """The gradient of :func:`flash_attention_cuda`'s function: q, out and
    dout (B,Sq,H,D), k/v (B,Skv,K,D), all of one dtype (bfloat16 or
    float32), contiguous; lse float32 (B,H,Sq) from the forward launch
    (``with_lse``).  Returns (dq, dk, dv) in the inputs' dtype, the
    contract of ``ref.flash_attention_bwd_ref``.  Deterministic: no
    atomics, every sum in one fixed order."""
    dev = q.device
    _check_tensors(dev, (("q", q), ("k", k), ("v", v), ("out", out),
                         ("dout", dout), ("lse", lse)))
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype}: bfloat16 or float32 only")
    for name, t in (("k", k), ("v", v), ("out", out), ("dout", dout)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must have q's dtype")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be (B,Sq,H,D) and k, v (B,Skv,K,D)")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("out and dout must have q's shape")
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or sq < 1 or skv < 1:
        raise ValueError("q/k/v shapes disagree")
    if lse.dtype != torch.float32 or lse.shape != (b, h, sq):
        raise ValueError("lse must be float32 (B,H,Sq)")
    if h % kh:
        raise ValueError(f"H={h} must be a multiple of K={kh}")
    if d not in INSTANCES:
        raise ValueError(f"head dim {d}: the kernel takes {sorted(INSTANCES)}")
    if h // kh > BWD_ROWS:
        raise ValueError(f"{h // kh} query heads per kv head exceed one CTA")
    smem = bwd_smem_bytes(d, q.dtype)
    if smem > MAX_SMEM:
        raise ValueError(f"head dim {d} in {q.dtype} needs {smem} bytes of "
                         f"shared memory, above {MAX_SMEM}")
    if q_offset < 0:
        raise ValueError("q_offset must be >= 0")
    scale_q = float(torch.tensor(d ** -0.5, dtype=q.dtype))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if _bwd_tc(d, q.dtype):
        # the scaled q rows and each query tile's lse and Delta, written by
        # the dQ kernel for the dK/dV kernel
        qs = torch.empty_like(q)
        n_qt = -(-sq // (BWD_TILE // (h // kh)))
        scratch = torch.empty(b * kh * n_qt * BWD_AUX, dtype=torch.float32,
                              device=dev)
    else:
        qs = None
        scratch = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_bwd_launcher()(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if qs is None else qs.data_ptr(), b, sq, skv, h, kh, d,
            int(bool(causal)), int(window), int(q_offset), scale_q, stream),
            "flash_attention_bwd_launch")
    return dq, dk, dv
