"""Model zoo facade, the dense cache's growth and the page layout helpers
of the paged serving plane.

The port of ``repro.models.zoo``: ``build_model``; the inputs of an (arch
x shape) cell, abstract (``input_shapes``, on the ``meta`` device, so
nothing is allocated at ``decode_32k`` or ``long_500k``) or small and
concrete (``concrete_inputs``, from an explicit ``torch.Generator``), and
their mesh axes under a rule table (``input_logical``, ``cache_specs``);
``param_count_estimate``; ``pad_cache``, which
grows a prefill cache so ``decode_step`` can append (the restart baseline);
and the admission path's helpers — prefill ONE request and scatter its
cache into the endpoint's fixed-shape paged state (``prefill_into_pages``),
zero a slot's recurrent state (``reset_slot``), and size a request's pages
(``pages_per_request``).  Every family of the reference builds: the
encoder-decoder as ``EncDecLM``, every other family as ``DecoderLM``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.common import ParamDecl
from repro_torch.configs.base import ModelConfig, ShapeConfig
from .encdec import EncDecLM
from .transformer import DecoderLM


def build_model(cfg: ModelConfig) -> DecoderLM:
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    return DecoderLM(cfg)


# ---------------------------------------------------------------------------
# The inputs of an (arch x shape) cell
# ---------------------------------------------------------------------------

def input_shapes_keys(cfg: ModelConfig, shape: ShapeConfig) -> List[str]:
    keys = []
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec" or cfg.frontend != "none":
            keys.append("embeds")
        keys.append("tokens")
    else:
        keys += ["token", "cache"]
    return keys


def _empty_cache(cfg: ModelConfig, b: int, s: int, device) -> dict:
    model = build_model(cfg)
    if cfg.family == "encdec":
        return model.empty_cache(b, s, enc_len=s, device=device)
    return model.empty_cache(b, s, device=device)


def input_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The cell's inputs as tensors on the ``meta`` device: shapes and
    dtypes, no storage.  A decode cell's ``cache`` is ``empty_cache``'s
    tree with ``pos`` a 0-d int32 tensor, the reference's leaf (a live
    cache carries ``pos`` as a Python int)."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=meta)

    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            out["embeds"] = spec((b, s, cfg.d_model), torch.bfloat16)
            out["tokens"] = spec((b, s), torch.int32)
        elif cfg.frontend != "none":
            flen = cfg.frontend_len
            out["embeds"] = spec((b, flen, cfg.d_model), torch.bfloat16)
            out["tokens"] = spec((b, s - flen), torch.int32)
        else:
            out["tokens"] = spec((b, s), torch.int32)
    else:
        out["token"] = spec((b, 1), torch.int32)
        cache = _empty_cache(cfg, b, s, meta)
        cache["pos"] = spec((), torch.int32)
        out["cache"] = cache
    return out


# the logical axes of a cache leaf, by its key (parallel to the buffers of
# ``DecoderLM.empty_cache``: the layer axis leads)
_CACHE_LOGICAL = {
    "k": (None, "cache_batch", "cache_seq", "cache_kv_heads", None),
    "v": (None, "cache_batch", "cache_seq", "cache_kv_heads", None),
    "k_scale": (None, "cache_batch", "cache_seq", "cache_kv_heads"),
    "v_scale": (None, "cache_batch", "cache_seq", "cache_kv_heads"),
    "ck": (None, "cache_batch", "cache_seq", "cache_kv_heads", None),
    "cv": (None, "cache_batch", "cache_seq", "cache_kv_heads", None),
    "s": (None, "cache_batch", None, None, None),
    "conv": (None, "cache_batch", None, None),
    "c": (None, "cache_batch", None, None),
    "n": (None, "cache_batch", None, None),
    "h": (None, "cache_batch", None, None),
}


def cache_specs(cache_shape_tree, rules) -> Dict[str, Any]:
    """The mesh axes of every leaf of a cache built by ``empty_cache``
    (meta tensors will do), under ``rules``; ``pos`` is replicated."""
    return {"pos": (), "segs": [
        [{key: rules.spec(_CACHE_LOGICAL[key][:leaf.dim()])
          for key, leaf in layer.items()} for layer in seg]
        for seg in cache_shape_tree["segs"]]}


def input_logical(cfg: ModelConfig, shape: ShapeConfig, rules
                  ) -> Dict[str, Any]:
    """The mesh axes of ``input_shapes``'s tree under ``rules``: the batch
    axis of the inputs (``"batch"``), a decode cell's cache by
    :func:`cache_specs`."""
    specs: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        if "embeds" in input_shapes_keys(cfg, shape):
            specs["embeds"] = rules.spec(("batch", None, None))
        specs["tokens"] = rules.spec(("batch", None))
    else:
        specs["token"] = rules.spec(("batch", None))
        specs["cache"] = cache_specs(input_shapes(cfg, shape)["cache"], rules)
    return specs


def concrete_inputs(cfg: ModelConfig, shape: ShapeConfig,
                    gen: torch.Generator,
                    batch_override: Optional[int] = None,
                    seq_override: Optional[int] = None) -> Dict[str, Any]:
    """Small concrete inputs for smoke runs, drawn from ``gen`` on its own
    device: bf16 normal embeddings, int32 tokens in ``[0, vocab)``; a
    decode cell's zeroed cache at ``pos = s // 2``."""
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len
    dev = gen.device

    def normal(dims):
        return torch.randn(dims, generator=gen, device=dev).to(torch.bfloat16)

    def tokens(dims):
        return torch.randint(0, cfg.vocab_size, dims, generator=gen,
                             device=dev, dtype=torch.int32)

    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            out["embeds"] = normal((b, s, cfg.d_model))
            out["tokens"] = tokens((b, s))
        elif cfg.frontend != "none":
            flen = min(cfg.frontend_len, s // 2)
            out["embeds"] = normal((b, flen, cfg.d_model))
            out["tokens"] = tokens((b, s - flen))
        else:
            out["tokens"] = tokens((b, s))
    else:
        out["token"] = tokens((b, 1))
        cache = _empty_cache(cfg, b, s, dev)
        cache["pos"] = s // 2
        out["cache"] = cache
    return out


def count_params(decls) -> int:
    """Elements over every ``ParamDecl`` leaf of a declaration tree."""
    if isinstance(decls, ParamDecl):
        return math.prod(decls.shape)
    nodes = decls.values() if isinstance(decls, dict) else decls
    return sum(count_params(v) for v in nodes)


def param_count_estimate(cfg: ModelConfig) -> int:
    return count_params(build_model(cfg).decls())


def pad_cache(cache: dict, t_max: int) -> dict:
    """Grow the KV buffers (dim 2 of the ``(layers, B, T, K, D)`` leaves,
    and of an int8 cache's ``(layers, B, T, K)`` scales; an encoder-decoder
    cache's encoder K/V ``ck``/``cv`` stay as they are) to ``t_max``
    positions with zeros; a new cache, ``pos`` kept.  Needed after
    ``prefill`` before ``decode_step`` can append new tokens."""
    def grow(key, leaf):
        rank = 5 if key in _PAGED_KV_KEYS else 4
        if (key not in PAGED_POOL_KEYS or leaf.dim() != rank
                or leaf.shape[2] >= t_max):
            return leaf
        pad = [0, 0] * (rank - 3) + [0, t_max - leaf.shape[2]]
        return F.pad(leaf, pad)

    return {"pos": cache["pos"],
            "segs": [[{key: grow(key, leaf) for key, leaf in layer.items()}
                      for layer in seg]
                     for seg in cache["segs"]]}


_PAGED_KV_KEYS = ("k", "v")
_PAGED_SCALE_KEYS = ("k_scale", "v_scale")
# every cache leaf living in a shared page pool (vs per-slot recurrent
# state) — the serving engine classifies models by this same set
PAGED_POOL_KEYS = _PAGED_KV_KEYS + _PAGED_SCALE_KEYS


def prefill_into_pages(state: dict, cache: dict, page_ids, slot,
                       page_size: int) -> dict:
    """Scatter a single-request prefill ``cache`` (batch 1, length t) into
    the paged ``state`` IN PLACE and return it.

    ``page_ids``: (ceil(t / page_size),) physical pages owned by the request
    (its block-table prefix).  KV positions past t (the bucket pad tail)
    scatter zeros — masked by ``lens`` at attention time and overwritten as
    decode advances.  An int8 cache's scales ``(L, 1, t, K)`` scatter into
    their ``(L, n_pages, PS, K)`` pools the same way.  Recurrent state
    ``(L, 1, ...)`` goes to the request's ``slot`` of its ``(L, n_slots,
    ...)`` buffer.  The reference's functional ``pool.at[:, ids].set`` is
    an indexed assignment into the pool here, so no pool is copied."""
    page_ids = torch.as_tensor(page_ids, dtype=torch.long)
    n_chunk = page_ids.shape[0]
    for seg_s, seg_c in zip(state["segs"], cache["segs"]):
        for layer_state, layer_cache in zip(seg_s, seg_c):
            for key, leaf in layer_cache.items():
                if key not in PAGED_POOL_KEYS:   # per-slot recurrent state
                    layer_state[key][:, slot] = leaf[:, 0]
                    continue
                pool = layer_state[key]          # (L, n_pages, PS, K[, D])
                l, _, t = leaf.shape[:3]         # (L, 1, t, K[, D])
                pad = [0, 0] * (leaf.dim() - 3) + [0, n_chunk * page_size - t]
                kv = F.pad(leaf[:, 0], pad)
                pool[:, page_ids.to(pool.device)] = kv.reshape(
                    l, n_chunk, page_size, *leaf.shape[3:]).to(pool.dtype)
    return state


def reset_slot(state: dict, slot: int) -> dict:
    """Zero a slot's recurrent state IN PLACE (admission of a prompt too
    short to prefill).  KV pages need no reset — ``lens`` masking covers
    them."""
    for seg in state["segs"]:
        for layer_state in seg:
            for key, pool in layer_state.items():
                if key not in PAGED_POOL_KEYS:
                    pool[:, slot] = 0
    return state


def pages_per_request(prompt_len: int, max_new: int, page_size: int) -> int:
    """Physical pages a request needs over its whole lifetime: prefix plus
    every decode write (positions 0 .. prompt_len + max_new - 1)."""
    return -(-(prompt_len + max_new) // page_size)
