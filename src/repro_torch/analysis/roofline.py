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
what a query-sharded dual solve should gather, ``sharded_train_bytes``
what one FSDP x TP train step (``training.sharded``) moves on a rank.
"""
from __future__ import annotations

import math
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


def sharded_train_bytes(model, tcfg, params, rules, mesh_shape, rows: int,
                        seq: int) -> Dict[str, int]:
    """Result bytes by kind that one step of ``Trainer.sharded_step``
    moves on each rank, from the declarations' logical axes, their specs
    under ``rules``, the whole parameters' shapes and dtypes (``params``,
    real or meta tensors, as the state runs) and the rank's batch (``rows``
    sequences of ``seq`` positions) on a mesh of ``mesh_shape`` {"data":
    dp, "model": tp}.  Per leaf, with g microbatches and r = 2 under remat
    (the backward runs a layer's forward again up to its last saved
    tensor, where PyTorch's checkpoint stops: the gathers and the
    attention's all-reduce, not the MLP's), else 1:

    * all-gather: a leaf sharded over ``data`` gathers its blocks (the
      result: the leaf over its ``model`` split), a ``p_vocab`` leaf then
      gathers over ``model`` (the whole leaf); g x r times for a layer's
      leaf, g times for the tables, once (r = 1) under ``hoist_gather``; int8
      moments gather both moments' row maxima of a leaf whose last dim is
      split (n x its local rows, float32);
    * reduce-scatter: the gradient of a ``data``-sharded leaf onto its
      block, g times in the parameter's dtype, or once in the accumulator's
      under ``hoist_gather``;
    * all-reduce: per microbatch the scored positions and the NLL sum (8
      bytes, over ``data``); per layer and microbatch r + 3 activations
      (rows / g x seq x d) over ``model`` (two in the forward, one in the
      recompute, two in the backward); at the end the gradient of every
      leaf not sharded over ``data`` (over ``data``) and of the replicated
      KV projections (over ``model``), in the accumulator's dtype; the
      squared norm (4 bytes)."""
    from repro_torch.common.params import dim_axes, param_specs, spec_leaves
    from repro_torch.training.optim import tree_leaves
    cfg = model.cfg
    dp, tp = mesh_shape["data"], mesh_shape["model"]
    g = tcfg.microbatches
    rounds = 1 if tcfg.hoist_gather else g
    remat = 2 if cfg.remat != "none" else 1
    acc = 2 if tcfg.accum_dtype == "bf16" else 4
    decls = tree_leaves(model.decls())
    specs = param_specs(model.decls(), rules)
    leaves = tree_leaves(params)
    sizes = {"data": dp, "model": tp}
    out = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    for decl, spec, leaf in zip(decls, spec_leaves(specs), leaves):
        numel, item = leaf.numel(), leaf.element_size()
        axes = [dim_axes(e) for e in spec]
        split = math.prod(sizes[a] for ax in axes for a in ax)
        local = numel // split
        on_data = any("data" in ax for ax in axes)
        on_model = any("model" in ax for ax in axes)
        vocab = any("model" in ax and lg == "p_vocab"
                    for ax, lg in zip(axes, decl.logical))
        layer = decl.logical[0] == "p_layers" and not tcfg.hoist_gather
        per = rounds * (remat if layer else 1)
        if on_data and dp > 1:
            out["all-gather"] += per * item * numel // (tp if on_model
                                                          else 1)
            out["reduce-scatter"] += (local * acc if tcfg.hoist_gather
                                      else g * local * item)
        if vocab and tp > 1:
            out["all-gather"] += per * item * numel
        if not on_data and dp > 1:
            out["all-reduce"] += local * acc
        if (tp > 1 and "p_kv_heads" in decl.logical
                and rules.mesh_axes("p_kv_heads") is None):
            out["all-reduce"] += local * acc
        n_last = math.prod(sizes[a] for a in axes[-1]) if axes else 1
        if tcfg.moment_dtype == "int8" and n_last > 1:
            out["all-gather"] += 2 * n_last * 4 * local // (
                leaf.shape[-1] // n_last)
    layers = sum(c * len(p) for c, p in model.plan)
    if dp > 1:
        out["all-reduce"] += 8 * g
    if tp > 1:
        act = rows // g * seq * cfg.d_model * params["embed"].element_size()
        out["all-reduce"] += layers * g * (remat + 3) * act
    if dp * tp > 1:
        out["all-reduce"] += 4
    return out


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
