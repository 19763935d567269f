"""Python wrapper of the hand-written CUDA dual solve (``csrc/dual_solve.cu``).

``dual_solve_cuda`` runs the whole dual ascent in one launch on the current
stream and returns the packed, fully finalised ``(8 + 3M,)`` vector — the
contract of ``ref.fused_dual_solve_ref``.  It takes CUDA tensors only; the
library builds from the repository's sources at first use.
``shard_stats_cuda`` (``csrc/shard_stats.cu``) computes one iteration's
per-shard ``[ΣA, ΣB, histogram]`` for the blocked, masked window solve —
the contract of ``ref.shard_stats_ref``.
``assign_step_cuda`` (the second entry point of ``csrc/shard_stats.cu``)
runs one step of the seed's per-iteration solve — reduced-cost argmin,
histogram, qsum and csum — the contract of ``ref.assign_step_ref``.
``l2_read_probe_cuda`` measures the single-CTA design's own limit, one SM's
L2 read rate; it is a measurement aid and no part of the routing path.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build

MMAX = 16     # models per solve the kernels hold in shared memory
STATS_ROWS = 256   # rows per block of the shard-statistics kernel


@lru_cache(maxsize=1)
def _launcher():
    fn = _build.load("dual_solve").dual_solve_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
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
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=1)
def _probe_launcher():
    fn = _build.load("dual_solve").l2_read_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def l2_read_probe_cuda(buf: torch.Tensor, reps: int) -> torch.Tensor:
    """One CTA as wide as the dual solve's reads the contiguous float32
    CUDA tensor ``buf`` (numel a multiple of 4) ``reps`` times; returns the
    (1,) sum.  Timing it gives one SM's L2 read rate when ``buf`` fits L2."""
    if buf.device.type != "cuda" or buf.dtype != torch.float32:
        raise ValueError("l2_read_probe_cuda needs a float32 CUDA tensor")
    if not buf.is_contiguous() or buf.numel() % 4 or buf.numel() < 4:
        raise ValueError("l2_read_probe_cuda needs a contiguous buffer of "
                         "a multiple of 4 floats")
    out = torch.empty(1, dtype=torch.float32, device=buf.device)
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        _build.check(_probe_launcher()(buf.data_ptr(), buf.numel(), int(reps),
                                       out.data_ptr(), stream),
                     "l2_read_probe_launch")
    return out


def dual_solve_cuda(a_mat, b_mat, thresh, lr_eff, lr_load, lam0, lam20,
                    stall_tol, step0, loads, *, iters: int, patience: int):
    """Same arguments and result as ``ref.fused_dual_solve_ref``; every
    tensor must lie on one CUDA device."""
    dev = a_mat.device
    if dev.type != "cuda":
        raise ValueError(f"dual_solve_cuda needs CUDA tensors, got {dev}")
    n, m = a_mat.shape
    if b_mat.shape != (n, m):
        raise ValueError(f"A {tuple(a_mat.shape)} and B {tuple(b_mat.shape)} "
                         "differ in shape")
    if not 1 <= m <= MMAX:
        raise ValueError(f"dual_solve_cuda holds 1..{MMAX} models, got {m}")

    def f32(v):
        t = torch.as_tensor(v, dtype=torch.float32, device=dev)
        if t.device != dev:
            raise ValueError(f"argument on {t.device}, expected {dev}")
        return t.reshape(-1)

    ab = torch.cat([f32(a_mat).reshape(n, m), f32(b_mat).reshape(n, m)],
                   dim=1).contiguous()                        # (N, 2M)
    scal = torch.cat([f32(v) for v in (thresh, lr_eff, lr_load, lam0,
                                       stall_tol, step0)]).contiguous()
    aux = torch.cat([f32(loads), f32(lam20)]).contiguous()    # loads | λ2_0
    if scal.numel() != 6 or aux.numel() != 2 * m:
        raise ValueError("scalars must be 0-dim; loads and lam20 (M,)")
    out = torch.empty(8 + 3 * m, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_launcher()(ab.data_ptr(), scal.data_ptr(),
                                 aux.data_ptr(), out.data_ptr(), n, m,
                                 int(iters), int(patience), stream),
                     "dual_solve_launch")
    return out


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


def assign_step_cuda(cost, quality, lam1, lam2):
    """Same arguments and result as ``ref.assign_step_ref`` with n = N:
    cost/quality (N, M) float32, lam1 a 0-dim float32 tensor, lam2 (M,);
    returns (x (N,) int32, counts (M,) f32, qsum, csum).  Every tensor must
    lie on one CUDA device; nothing is read on the host."""
    dev = cost.device
    if dev.type != "cuda":
        raise ValueError(f"assign_step_cuda needs CUDA tensors, got {dev}")
    n, m = cost.shape
    if tuple(quality.shape) != (n, m):
        raise ValueError(f"cost {tuple(cost.shape)} and quality "
                         f"{tuple(quality.shape)} differ in shape")
    if not 1 <= m <= MMAX:
        raise ValueError(f"assign_step_cuda holds 1..{MMAX} models, got {m}")
    if n < 1:
        raise ValueError("assign_step_cuda needs at least one row")

    def f32(t, k):
        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        if t.device != dev or t.numel() != k:
            raise ValueError(f"argument on {t.device} with {t.numel()} "
                             f"elements, expected {k} on {dev}")
        return t.reshape(-1).contiguous()

    c, a = f32(cost, n * m), f32(quality, n * m)
    lam = torch.cat([f32(lam1, 1), f32(lam2, m)])
    bps = -(-n // STATS_ROWS)
    x = torch.empty(n, dtype=torch.int32, device=dev)
    part = torch.empty((bps, 2 + m), dtype=torch.float32, device=dev)
    out = torch.empty(2 + m, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(_step_launcher()(
            c.data_ptr(), a.data_ptr(), lam.data_ptr(), x.data_ptr(),
            part.data_ptr(), out.data_ptr(), n, m, bps, stream),
            "assign_step_launch")
    return x, out[2:], out[0], out[1]
