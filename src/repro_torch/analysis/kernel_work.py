"""The work of each hand-written kernel, as a function of its call's shapes.

No profiler counts what a hand kernel moves and computes, so this module
does, in place of the reference's HLO reader (``repro.analysis.hlo_static``:
``dot_flops`` / ``traffic_bytes``).  Each function returns ``(bytes,
operations)`` for one call on the data it is given: every input read once,
every output written once, and the operations this call's data needs (a
causal mask, a window, the valid rows), not the most it could need.  The
rows are those of PERF.md's kernel table; ``roofline.bound_ms`` turns a
count into the least time the card could take, at the peak rate of the
operations' type.  A benchmark reads the same count whatever implements
the kernel.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .roofline import HBM_BW, PEAK_FLOPS, PEAK_FP32, PEAK_TF32, bound_ms

Work = Tuple[float, float]


def peak_for(elem: int) -> float:
    """The product's rate: bf16 (2-byte operands) on the tensor cores,
    float32 on the CUDA cores."""
    return PEAK_FLOPS if elem == 2 else PEAK_FP32


# -- rows 6-8: paged decode, paged verify, dense decode -----------------------

def decode_attention(lens, heads: int, kv_heads: int, head_dim: int,
                     window: int, elem: int, table_entries: int = 0) -> Work:
    """One paged decode (rows 6; ``table_entries`` the block table's B·P
    entries) or dense decode (row 8, ``table_entries`` 0) over ``lens``
    (one length a sequence): q and the output once, each valid position's K
    and V row once, the block table and lens once; 4·H·D operations per
    valid position (Q·K and P·V)."""
    n = np.maximum(np.asarray(lens, np.int64), 0)
    if window > 0:
        n = np.minimum(n, window)
    b = n.shape[0]
    valid = int(n.sum())
    nbytes = (2 * b * heads * head_dim * elem
              + 2 * valid * kv_heads * head_dim * elem
              + 4 * table_entries + 4 * b)
    return nbytes, 4.0 * valid * heads * head_dim


def verify_attention(lens, positions: int, heads: int, kv_heads: int,
                     head_dim: int, window: int, elem: int,
                     table_entries: int) -> Work:
    """One paged verify of ``positions`` query positions a sequence (row
    7): q and the output once, the K and V rows of each sequence's longest
    row (lens + S - 1 positions) once, the block table and lens; 4·H·D
    operations per valid position of every query position."""
    n = np.maximum(np.asarray(lens, np.int64), 0)
    rows = n[:, None] + np.arange(positions)[None, :]
    if window > 0:
        rows = np.minimum(rows, window)
    b = n.shape[0]
    longest = int(rows[:, -1].sum())
    nbytes = (2 * b * positions * heads * head_dim * elem
              + 2 * longest * kv_heads * head_dim * elem
              + 4 * table_entries + 4 * b)
    return nbytes, 4.0 * float(rows.sum()) * heads * head_dim


def attention_bound(nbytes: float, nops: float, elem: int):
    """(bound ms, bound_by) of a decode or verify call: half the operations
    are the Q·K dots, exact on the tensor cores for bf16 inputs (elem 2);
    the P·V half stays in float32."""
    t_bytes = nbytes / HBM_BW
    t_ops = nops / 2 / peak_for(elem) + nops / 2 / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- rows 9 and 9b: flash attention forward and backward ----------------------

def _visible_pairs(s: int, skv: int, window: int, q_offset: int,
                   causal: bool) -> float:
    """(query position, key position) pairs the mask lets through."""
    pos = q_offset + np.arange(s)
    hi = np.minimum(pos + 1, skv) if causal else np.full(s, skv)
    lo = np.maximum(0, pos - window + 1) if window > 0 else 0
    return float(np.maximum(hi - lo, 0).sum())


def flash_forward(b: int, s: int, skv: int, heads: int, kv_heads: int,
                  head_dim: int, window: int, q_offset: int, elem: int,
                  causal: bool = True) -> Work:
    """One flash attention (row 9): q, k, v and the output once; 4·D
    operations per (query head, visible position) pair, both products at
    the operand type's rate (``peak_for``)."""
    pairs = _visible_pairs(s, skv, window, q_offset, causal)
    nbytes = elem * (2 * b * s * heads * head_dim
                     + 2 * b * skv * kv_heads * head_dim)
    return nbytes, 4.0 * head_dim * heads * b * pairs


def flash_backward(b: int, s: int, skv: int, heads: int, kv_heads: int,
                   head_dim: int, window: int, q_offset: int, elem: int,
                   causal: bool = True) -> Work:
    """One flash backward (row 9b): q, k, v, o, dO and the float32 lse
    read once, dq, dk, dv written once; five products of 2·D operations
    per (query head, visible position) pair at the operand type's rate."""
    pairs = _visible_pairs(s, skv, window, q_offset, causal)
    nbytes = (elem * (4 * b * s * heads * head_dim
                      + 4 * b * skv * kv_heads * head_dim)
              + 4 * b * heads * s)
    return nbytes, 10.0 * head_dim * heads * b * pairs


# -- rows 2-3: the retrieval vote and top-k -----------------------------------

def retrieval(b: int, n_rows: int, d: int, k: int, n_lab: int = 0) -> Work:
    """One retrieval over ``n_rows`` valid store rows (rows 2, 3; ``n_lab``
    0 for top-k): store rows, their labels, the queries, (vals, idx) and
    the votes once each; 2·d operations per (query, valid row)."""
    nbytes = (4 * (n_rows * d + n_rows * n_lab + b * d + b * n_lab)
              + 8 * b * k)
    return nbytes, 2.0 * b * n_rows * d


def retrieval_bounds(b: int, n_rows: int, d: int, k: int, n_lab: int = 0):
    """(float32 bound on the CUDA cores, 3xTF32 bound on the tensor cores:
    three TF32 products per operation), both in ms."""
    nbytes, nops = retrieval(b, n_rows, d, k, n_lab)
    return (bound_ms(nops, nbytes, PEAK_FP32),
            bound_ms(3 * nops, nbytes, PEAK_TF32))


# -- rows 1, 4, 5: the dual ascent, its blocked form, shard stats, the step ---

def dual_solve(n: int, m: int, iters_run: int) -> Work:
    """One fused dual solve (row 1): A and B read once, the multipliers,
    loads and SolveInfo scalars; (4M + 1) operations per row an
    iteration."""
    return (4 * (n * 2 * m + 6 + 2 * m + 8 + 3 * m),
            float(iters_run) * n * (4 * m + 1))


def blocked_ascent(valid_rows: int, padded_rows: int, m: int,
                   iters_run: int) -> Work:
    """A masked window's whole ascent in one launch (row 4's loop): the
    valid rows of A and B, the row mask, the multipliers; (4M + 1)
    operations per valid row an iteration."""
    return (4 * (2 * valid_rows * m + padded_rows + 8 + 4 * m),
            float(iters_run) * valid_rows * (4 * m + 1))


def shard_stats(n: int, m: int, lblocks: int) -> Work:
    """One shard-statistics call (row 4, one iteration): A and B read once,
    λ2 and nv, the (lblocks, 2+M) output; ~4·M operations per row."""
    return 4 * (2 * n * m + m + 1 + lblocks + lblocks * (2 + m)), 4.0 * n * m


def assign_step(n: int, m: int) -> Work:
    """One assign step (row 5): cost and quality read once, λ1, λ2, x and
    [qsum, csum, counts] written once; 5 operations per (row, model)."""
    return 4 * (2 * n * m + 1 + m + n + 2 + m), 5.0 * n * m


# -- the train step's dense floor ---------------------------------------------

def train_floor_s(n_params: float, tokens: int) -> float:
    """The dense floor of a train step under full remat: 6·N·tokens for
    the forward and backward plus 2·N·tokens for the recomputed forward,
    at the bf16 tensor-core rate."""
    return 8.0 * n_params * tokens / PEAK_FLOPS
