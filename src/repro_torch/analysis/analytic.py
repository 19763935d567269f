"""Analytic per-device HBM-traffic model of train, prefill and decode.

The port of ``repro.analysis.analytic``.  The memory term comes from the
physical buffer set, not from a trace:

train   : params (2 reads fwd+bwd, 1 grad write, re-read at update) x microbatches
          + optimizer state r/w + activations (write fwd, read bwd, remat re-read)
prefill : params read + KV cache write + activation stream
decode  : params read + KV cache read (+ one-token column write)

Every quantity is divided per device by the same sharding rules the
sharded programs run with (``distributed.sharding.rules_for``): a leaf's
bytes over the product of the mesh axes its spec names.  The mesh is the
port's ``launch.mesh.Mesh``; one built from a shape alone will do, since
only its axis sizes are read, and a one-device mesh gives the bytes on one
card.  ``memory_s`` is at the H100's ``roofline.HBM_BW``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.common import ShardingRules
from repro_torch.common.params import dim_axes, spec_leaves
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.training.optim import tree_leaves
from .roofline import HBM_BW


def _sharded_frac(spec, mesh) -> float:
    """1 / the product of the sizes of the mesh axes ``spec`` names."""
    denom = 1
    for entry in spec:
        for ax in dim_axes(entry):
            denom *= mesh.shape[ax]
    return 1.0 / denom


def params_bytes_per_device(decls, rules: ShardingRules, mesh) -> float:
    """Bytes of every ``ParamDecl`` leaf on one device: each leaf's bytes
    over the devices its spec under ``rules`` spreads it over."""
    total = 0.0
    for leaf in tree_leaves(decls):
        n = float(math.prod(leaf.shape)) if leaf.shape else 1.0
        total += (n * leaf.dtype.itemsize
                  * _sharded_frac(rules.spec(leaf.logical), mesh))
    return total


def cache_bytes_per_device(cache_struct, cache_spec_tree, mesh) -> float:
    """Bytes of every tensor leaf of a cache tree (``zoo.input_shapes``'
    meta tensors count all the same) on one device, under its spec tree
    (``zoo.cache_specs``)."""
    total = 0.0
    for st, sp in zip(tree_leaves(cache_struct),
                      spec_leaves(cache_spec_tree)):
        if not isinstance(st, torch.Tensor):
            continue                # a live cache's ``pos`` (an int)
        n = float(math.prod(st.shape)) if st.dim() else 1.0
        total += n * st.element_size() * _sharded_frac(sp, mesh)
    return total


def activation_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig, mesh,
                                microbatches: int = 1) -> float:
    """Residual-stream activation traffic per device for one full pass.

    Per layer we stream O(k·d) bytes per token (reads+writes of the
    residual, attention and FFN intermediates, bf16); k≈12 covers q/k/v/o +
    gate/up/down + norms.  Remat re-reads layer inputs once more on the
    backward pass.  The tokens split over the ``data`` (and ``pod``) axes;
    a decode batch smaller than that degree is replicated."""
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    tokens_pd = shape.global_batch * shape.seq_len / dp
    if shape.is_decode:
        tokens_pd = shape.global_batch / dp
        if shape.global_batch < dp:
            tokens_pd = float(shape.global_batch)
    k = 12.0
    layers = cfg.n_layers + cfg.n_enc_layers
    per_pass = tokens_pd * cfg.d_model * 2 * k * layers
    if shape.kind == "train":
        per_pass *= 2.5  # fwd + bwd + remat re-read
    return per_pass


def memory_term(cfg: ModelConfig, shape: ShapeConfig, mesh, rules, decls,
                cache_struct=None, cache_specs=None,
                tcfg: Optional[TrainConfig] = None) -> Dict[str, float]:
    """The memory roofline term of one step of ``shape`` on one device of
    ``mesh`` under ``rules``: parameter, cache and activation bytes, their
    traffic in all and its time at ``HBM_BW``."""
    p_pd = params_bytes_per_device(decls, rules, mesh)
    act = activation_bytes_per_device(
        cfg, shape, mesh, tcfg.microbatches if tcfg else 1)
    cache = 0.0
    if cache_struct is not None and cache_specs is not None:
        cache = cache_bytes_per_device(cache_struct, cache_specs, mesh)
    if shape.kind == "train":
        g = tcfg.microbatches if tcfg else 1
        # fwd read + bwd read per microbatch; grad write + accum r/w;
        # optimizer read/write (params + moments, int8 moments ≈ 2
        # bytes/param)
        moment_bytes = {"int8": 2.0, "bf16": 4.0, "fp32": 8.0}[
            tcfg.moment_dtype if tcfg else "fp32"]
        bytes_pd = p_pd * (2 * g + 3) + p_pd * moment_bytes / 2 + act
    elif shape.kind == "prefill":
        bytes_pd = p_pd + act + cache  # cache written once
    else:  # decode
        bytes_pd = p_pd + cache + act  # cache read once, column write ~0
    return {
        "params_bytes_pd": p_pd,
        "cache_bytes_pd": cache,
        "activation_bytes_pd": act,
        "memory_bytes_pd": bytes_pd,
        "memory_s": bytes_pd / HBM_BW,
    }
