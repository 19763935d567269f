"""Roofline terms on one NVIDIA H100.

The port of ``repro.analysis.roofline`` with the card's constants in
place of TPU v5e's.  The figures are the datasheet's for the H100 SXM5
80 GB (HBM3, 700 W; NVIDIA H100 Tensor Core GPU datasheet), dense, without
sparsity:

    compute term    = flops / PEAK_FLOPS   (bf16 on the tensor cores)
    memory term     = bytes / HBM_BW
    collective term = collective bytes / LINK_BW   (NVLink 4, one direction)

``bound_ms`` is the least time a kernel could take for its work: the larger
of its bytes over the memory rate and its operations over the peak rate of
their type (``PEAK_FLOPS``, ``PEAK_TF32`` or ``PEAK_FP32``).
:mod:`repro_torch.analysis.kernel_work` counts each hand kernel's work.

The reference's ``collective_bytes`` parses XLA's HLO text for the result
bytes of its collectives.  The port's reads the byte counters of the
collective wrappers of :mod:`repro_torch.launch.mesh`, through which every
collective of the port runs: result bytes by kind (``all-gather``,
``all-to-all``, ``all-reduce``, ``send/recv``, ``broadcast``) and a count,
on this rank since the counters' last reset.  ``sharded_solve_bytes`` is
what a query-sharded dual solve should gather.
"""
from __future__ import annotations

from typing import Dict

PEAK_FLOPS = 989e12      # bf16 on the tensor cores, dense / card
PEAK_TF32 = 495e12       # TF32 on the tensor cores, dense / card
PEAK_FP32 = 67e12        # float32 on the CUDA cores / card
HBM_BW = 3.35e12         # bytes/s / card
LINK_BW = 450e9          # bytes/s, NVLink 4, one direction / card


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32) -> float:
    """max(bytes / HBM_BW, flops / peak) in ms."""
    return max(nbytes / HBM_BW, flops / peak) * 1e3


def bound_by(flops: float, nbytes: float, peak: float = PEAK_FP32) -> str:
    """Which side sets ``bound_ms``: "bytes" or "operations"."""
    return "bytes" if nbytes / HBM_BW >= flops / peak else "operations"


def collective_bytes() -> Dict[str, int]:
    """This rank's collective result bytes by kind, and the count of
    collectives, since ``launch.mesh.reset_collectives()``."""
    from repro_torch.launch.mesh import collective_stats
    return collective_stats()


def sharded_solve_bytes(loop_iters: int, shards: int, m: int, n: int, *,
                        norm_grad: bool) -> int:
    """All-gather result bytes of one query-sharded blocked solve on each
    rank: each iteration the loop ran gathers every shard's [ΣA, ΣB,
    histogram] (S × (2 + M) float32); the prologue gathers two per-shard
    sums with ``norm_grad``; the SolveInfo and the ledger five chosen sums
    (S float32 each) and the counts (S × M float32); and the final x, N
    int64."""
    return 4 * shards * ((2 + m) * loop_iters + 2 * norm_grad + 5 + m) \
        + 8 * n


def roofline_terms(flops_pd: float, bytes_pd: float,
                   coll_bytes_pd: float) -> Dict[str, float]:
    t_compute = flops_pd / PEAK_FLOPS
    t_memory = bytes_pd / HBM_BW
    t_coll = coll_bytes_pd / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant
    bound = max(t_compute, t_memory, t_coll)
    terms["roofline_fraction_compute"] = t_compute / bound if bound > 0 else 0.0
    return terms


def model_flops(active_params: int, tokens: int, *, training: bool) -> float:
    """6·N·D for training, 2·N·D for inference (standard MFU reference)."""
    return (6.0 if training else 2.0) * active_params * tokens
