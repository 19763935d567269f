"""Analytic HBM-traffic model of train, prefill and decode on one card.

The port of ``repro.analysis.analytic``.  The memory term comes from the
physical buffer set, not from a trace:

train   : params (2 reads fwd+bwd, 1 grad write, re-read at update) x microbatches
          + optimizer state r/w + activations (write fwd, read bwd, remat re-read)
prefill : params read + KV cache write + activation stream
decode  : params read + KV cache read (+ one-token column write)

The reference divides every buffer by the devices its sharding rule spreads
it over; on one card every such fraction is 1, and the mesh and rules
arguments come back with distribution (ROADMAP Queue A).  The bytes are the
reference's on a one-device mesh; ``memory_s`` is at the H100's
``roofline.HBM_BW``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.common import ParamDecl
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from .roofline import HBM_BW


def params_bytes(decls) -> float:
    """Bytes of every ``ParamDecl`` leaf of a declaration tree."""
    if isinstance(decls, ParamDecl):
        return float(math.prod(decls.shape)) * decls.dtype.itemsize
    nodes = decls.values() if isinstance(decls, dict) else decls
    return sum(params_bytes(v) for v in nodes)


def cache_bytes(cache) -> float:
    """Bytes of every tensor leaf of a cache tree (``zoo.input_shapes``'
    meta tensors hold no storage and count all the same)."""
    if isinstance(cache, torch.Tensor):
        return float(cache.numel()) * cache.element_size()
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for v in cache.values())
    if isinstance(cache, (list, tuple)):
        return sum(cache_bytes(v) for v in cache)
    return 0.0


def activation_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Residual-stream activation traffic for one full pass.

    Per layer we stream O(k·d) bytes per token (reads+writes of the
    residual, attention and FFN intermediates, bf16); k≈12 covers q/k/v/o +
    gate/up/down + norms.  Remat re-reads layer inputs once more on the
    backward pass."""
    tokens = float(shape.global_batch * shape.seq_len)
    if shape.is_decode:
        tokens = float(shape.global_batch)
    k = 12.0
    layers = cfg.n_layers + cfg.n_enc_layers
    per_pass = tokens * cfg.d_model * 2 * k * layers
    if shape.kind == "train":
        per_pass *= 2.5  # fwd + bwd + remat re-read
    return per_pass


def memory_term(cfg: ModelConfig, shape: ShapeConfig, decls, cache=None,
                tcfg: Optional[TrainConfig] = None) -> Dict[str, float]:
    p = params_bytes(decls)
    act = activation_bytes(cfg, shape)
    c = cache_bytes(cache) if cache is not None else 0.0
    if shape.kind == "train":
        g = tcfg.microbatches if tcfg else 1
        # fwd read + bwd read per microbatch; grad write + accum r/w;
        # optimizer read/write (params + moments, int8 moments ≈ 2
        # bytes/param)
        moment_bytes = {"int8": 2.0, "bf16": 4.0, "fp32": 8.0}[
            tcfg.moment_dtype if tcfg else "fp32"]
        total = p * (2 * g + 3) + p * moment_bytes / 2 + act
    elif shape.kind == "prefill":
        total = p + act + c  # cache written once
    else:  # decode
        total = p + c + act  # cache read once, column write ~0
    return {
        "params_bytes_pd": p,
        "cache_bytes_pd": c,
        "activation_bytes_pd": act,
        "memory_bytes_pd": total,
        "memory_s": total / HBM_BW,
    }
