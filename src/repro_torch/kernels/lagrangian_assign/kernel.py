"""Python wrappers of the hand-written CUDA kernels of the dual solve.

``dual_solve_cuda`` (``csrc/dual_solve.cu``) runs the whole dual ascent in
one launch of one thread-block cluster on the current stream and returns
the packed, fully finalised ``(8 + 3M,)`` vector — the contract of
``ref.fused_dual_solve_ref``.  ``blocked_dual_ascent_cuda`` (the same
kernel's second entry point) runs the blocked, masked window solve's whole
ascent over S query shards — the contract of
``ref.blocked_dual_ascent_ref``, bit for bit.  Both record the cluster
they launched in ``cluster`` (CTAs, whether the rows sit in shared memory)
and print it the first time it changes.
``shard_stats_cuda`` (``csrc/shard_stats.cu``) computes one iteration's
per-shard ``[ΣA, ΣB, histogram]`` of that ascent on its own — the contract
of ``ref.shard_stats_ref``; the ascent's kernel reduces each block in the
same order (``csrc/block_partial.cuh``).
``assign_step_cuda`` (the second entry point of ``csrc/shard_stats.cu``)
runs one step of the seed's per-iteration solve — reduced-cost argmin,
histogram, qsum and csum — the contract of ``ref.assign_step_ref``, in
one launch: the CTA that finishes last adds the block partials in block
order and resets the ticket counter it drew from.  Its fast path (float32,
contiguous, every tensor on one device) allocates only the two outputs;
the partials and the counter are scratch kept per (device, stream).
They take CUDA tensors only; the libraries build from the repository's
sources at first use.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build

MMAX = 16     # models per solve the kernels hold in shared memory
STATS_ROWS = 256   # rows per block of the shard-statistics kernel
# every CTA of the dual-ascent cluster holds every 256-row block's partial
# (2 + M floats): at most this many bytes of them (csrc/dual_solve.cu)
MAX_GATHER_BYTES = 160 * 1024

# the last dual-solve launch's cluster: (CTAs, rows in shared memory)
cluster = None


@lru_cache(maxsize=None)
def _ascent_launcher(entry: str, pointers: int, ints: int):
    fn = getattr(_build.load("dual_solve"), entry)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [
        ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=1)
def _stats_launcher():
    fn = _build.load("shard_stats").shard_stats_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=1)
def _step_launcher():
    fn = _build.load("shard_stats").assign_step_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# The assign step's scratch, by (device, stream, blocks, M): the block
# partials and the ticket counter, as data pointers beside their tensors.
# The stream is in the key because launches on one stream run in order and
# may share one counter and one set of partials, while two streams may run
# at once and would race on them; so a CUDA-graph capture on a side stream
# gets scratch of its own.  The counter is zeroed once, when its entry is
# made, and every launch leaves it at 0.  Entries are never freed: a
# captured graph keeps their addresses.  An entry is made outside a CUDA-graph
# capture only (a zeroing captured into a graph would run at replays alone):
# call the step once on a stream before capturing on it.
_step_scratch = {}


def _scratch(dev, stream, bps, m):
    key = (dev.index, stream, bps, m)
    got = _step_scratch.get(key)
    if got is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "assign_step_cuda: first call on this stream, with these "
                "shapes, inside a CUDA-graph capture; call it once on the "
                "stream before capturing")
        part = torch.empty(bps * (2 + m), dtype=torch.float32, device=dev)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        got = _step_scratch[key] = (part.data_ptr(), ticket.data_ptr(),
                                    part, ticket)
    return got


def _ascent(entry, what, a_mat, b_mat, nv, scalars, lam20, loads, *,
            iters: int, patience: int):
    """Check the arguments, allocate the output, launch ``entry``; ``nv``
    None is the one-shot solve (one shard, every row valid)."""
    global cluster
    nloc, m = a_mat.shape
    if tuple(b_mat.shape) != (nloc, m):
        raise ValueError(f"A {tuple(a_mat.shape)} and B "
                         f"{tuple(b_mat.shape)} differ in shape")
    if not 1 <= m <= MMAX:
        raise ValueError(f"{what} holds 1..{MMAX} models, got {m}")
    lblocks = 1
    if nv is not None:
        nv = torch.as_tensor(nv)
        if nv.dim() != 1 or len(nv) < 1 or nloc % len(nv):
            raise ValueError(f"nv_loc {tuple(nv.shape)} is not one count "
                             f"per shard of {nloc} rows")
        lblocks = len(nv)
    units = lblocks * max(-(-(nloc // lblocks) // STATS_ROWS), 1)
    if units * (2 + m) * 4 > MAX_GATHER_BYTES:
        raise ValueError(f"{what}: {units} blocks of 256 rows exceed the "
                         f"cluster's {MAX_GATHER_BYTES} bytes of partials")
    dev = a_mat.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")

    def f32(t, n):
        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        if t.device != dev or t.numel() != n:
            raise ValueError(f"argument on {t.device} with {t.numel()} "
                             f"elements, expected {n} on {dev}")
        return t.contiguous()

    ptrs = [f32(a_mat, nloc * m), f32(b_mat, nloc * m)]
    if nv is not None:
        ptrs.append(f32(nv, lblocks))
    t_eff, lr_eff, lr_load, lam0, stall_tol, step0 = (f32(v, 1)
                                                      for v in scalars)
    ptrs += [t_eff, lr_eff, lr_load, lam0, f32(lam20, m), stall_tol, step0,
             f32(loads, m)]
    out = torch.empty(8 + 3 * m, dtype=torch.float32, device=dev)
    ints = ((nloc,) if nv is None else (lblocks, nloc // lblocks)) + (
        m, int(iters), int(patience))
    info = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_ascent_launcher(entry, len(ptrs) + 1, len(ints))(
            *(t.data_ptr() for t in ptrs), out.data_ptr(), *ints,
            ctypes.addressof(info), stream), entry)
    chosen = (info[0], bool(info[1]))
    if chosen != cluster:
        cluster = chosen
        print(f"dual ascent kernel: a cluster of {chosen[0]} CTAs, rows "
              f"{'in shared memory' if chosen[1] else 'read from L2'}",
              flush=True)
    return out


def dual_solve_cuda(a_mat, b_mat, thresh, lr_eff, lr_load, lam0, lam20,
                    stall_tol, step0, loads, *, iters: int, patience: int):
    """Same arguments and result as ``ref.fused_dual_solve_ref``; every
    tensor must lie on one CUDA device."""
    return _ascent("dual_solve_launch", "dual_solve_cuda", a_mat, b_mat,
                   None, (thresh, lr_eff, lr_load, lam0, stall_tol, step0),
                   lam20, loads, iters=iters, patience=patience)


def blocked_dual_ascent_cuda(a_mat, b_mat, nv_loc, t_eff, lr_eff,
                             lr_load_eff, lam0, lam20, stall_tol, step0,
                             loads, *, iters: int, patience: int):
    """Same arguments and packed result as ``ref.blocked_dual_ascent_ref``
    (without its host-read count): a_mat/b_mat (S·nl, M) float32, nv_loc
    (S,) valid rows per shard.  Every tensor must lie on one CUDA device;
    nothing is read on the host, and the output is the one allocation."""
    return _ascent("blocked_dual_ascent_launch", "blocked_dual_ascent_cuda",
                   a_mat, b_mat, nv_loc,
                   (t_eff, lr_eff, lr_load_eff, lam0, stall_tol, step0),
                   lam20, loads, iters=iters, patience=patience)


def shard_stats_cuda(a_mat, b_mat, lam, lam2, nv, *, lblocks: int):
    """Same arguments and result as ``ref.shard_stats_ref``: a_mat/b_mat
    (lblocks·nl, M) float32, lam a 0-dim float32 tensor, lam2 (M,), nv
    (lblocks,) per-shard valid-row counts; returns (lblocks, 2 + M) float32.
    Every tensor must lie on one CUDA device; nothing is read on the host."""
    dev = a_mat.device
    if dev.type != "cuda":
        raise ValueError(f"shard_stats_cuda needs CUDA tensors, got {dev}")
    nloc, m = a_mat.shape
    if tuple(b_mat.shape) != (nloc, m):
        raise ValueError(f"A {tuple(a_mat.shape)} and B "
                         f"{tuple(b_mat.shape)} differ in shape")
    if not 1 <= m <= MMAX:
        raise ValueError(f"shard_stats_cuda holds 1..{MMAX} models, got {m}")
    if lblocks < 1 or nloc % lblocks:
        raise ValueError(f"{nloc} rows do not divide into {lblocks} shards")

    def f32(t, n):
        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        if t.device != dev or t.numel() != n:
            raise ValueError(f"argument on {t.device} with {t.numel()} "
                             f"elements, expected {n} on {dev}")
        return t.reshape(-1).contiguous()

    a = f32(a_mat, nloc * m)
    b = f32(b_mat, nloc * m)
    lam_t, lam2_t, nv_t = f32(lam, 1), f32(lam2, m), f32(nv, lblocks)
    nl = nloc // lblocks
    bps = -(-nl // STATS_ROWS)
    part = torch.empty((lblocks, bps, 2 + m), dtype=torch.float32,
                       device=dev)
    out = torch.empty((lblocks, 2 + m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_stats_launcher()(
            a.data_ptr(), b.data_ptr(), lam_t.data_ptr(), lam2_t.data_ptr(),
            nv_t.data_ptr(), part.data_ptr(), out.data_ptr(), lblocks, nl, m,
            bps, stream), "shard_stats_launch")
    return out


def _fast_ok(cost, quality, lam1, lam2) -> bool:
    """Whether the arguments go to the kernel as they are: float32 tensors
    on ``cost``'s device, cost/quality (N, M) contiguous with 1 <= M <= 16
    and N >= 1, lam1 one element, lam2 (M,) contiguous."""
    f32 = torch.float32
    if not (isinstance(lam1, torch.Tensor) and isinstance(lam2, torch.Tensor)
            and cost.dtype is f32 and quality.dtype is f32
            and lam1.dtype is f32 and lam2.dtype is f32
            and cost.dim() == 2 and quality.shape == cost.shape):
        return False
    n, m = cost.shape
    dev = cost.device
    return (1 <= m <= MMAX and n >= 1 and lam1.numel() == 1
            and lam2.numel() == m and quality.device == dev
            and lam1.device == dev and lam2.device == dev
            and cost.is_contiguous() and quality.is_contiguous()
            and lam2.is_contiguous())


def _slow_args(dev, cost, quality, lam1, lam2):
    """Check and convert what the fast path does not take: numbers, other
    dtypes and strides; a tensor on another device than ``dev`` raises."""
    n, m = cost.shape
    if tuple(quality.shape) != (n, m):
        raise ValueError(f"cost {tuple(cost.shape)} and quality "
                         f"{tuple(quality.shape)} differ in shape")
    if not 1 <= m <= MMAX:
        raise ValueError(f"assign_step_cuda holds 1..{MMAX} models, got {m}")
    if n < 1:
        raise ValueError("assign_step_cuda needs at least one row")

    def f32(t, k):
        if isinstance(t, torch.Tensor) and t.device != dev:
            raise ValueError(f"argument on {t.device}, expected {dev}")
        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        if t.numel() != k:
            raise ValueError(f"argument with {t.numel()} elements, "
                             f"expected {k}")
        return t.reshape(-1).contiguous()

    return (f32(cost, n * m), f32(quality, n * m), f32(lam1, 1),
            f32(lam2, m), n, m)


def _launch_step(dev, c, a, lam1, lam2, n, m):
    idx = dev.index
    if idx != torch.cuda.current_device():
        with torch.cuda.device(idx):
            return _launch_step(dev, c, a, lam1, lam2, n, m)
    x = torch.empty(n, dtype=torch.int32, device=dev)
    out = torch.empty(2 + m, dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(idx)
    part, ticket, _, _ = _scratch(dev, stream, -(-n // STATS_ROWS), m)
    _build.check(_step_launcher()(
        c.data_ptr(), a.data_ptr(), lam1.data_ptr(), lam2.data_ptr(),
        x.data_ptr(), part, ticket, out.data_ptr(), n, m, stream),
        "assign_step_launch")
    return x, out[2:], out[0], out[1]


def assign_step_cuda(cost, quality, lam1, lam2):
    """Same arguments and result as ``ref.assign_step_ref`` with n = N:
    cost/quality (N, M) float32, lam1 a 0-dim float32 tensor, lam2 (M,);
    returns (x (N,) int32, counts (M,) f32, qsum, csum).  Every tensor must
    lie on one CUDA device; nothing is read on the host.  Float32 contiguous
    tensors take the fast path (``_fast_ok``); numbers, other dtypes and
    strides are converted first.  Both launch the kernel."""
    dev = cost.device
    if dev.type != "cuda":
        raise ValueError(f"assign_step_cuda needs CUDA tensors, got {dev}")
    if _fast_ok(cost, quality, lam1, lam2):
        n, m = cost.shape
        return _launch_step(dev, cost, quality, lam1, lam2, n, m)
    return _launch_step(dev, *_slow_args(dev, cost, quality, lam1, lam2))
