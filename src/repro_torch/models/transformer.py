"""Decoder LM for the dense family (attention + gated MLP layers).

The port of ``repro.models.transformer.DecoderLM`` on the paths the serving
planes run: the full-sequence forward (``hidden``/``logits``), ``prefill``
(which returns the KV cache), the dense-cache single-token decode
(``empty_cache``, ``decode_step``: the restart-batching baseline), the
paged single-token decode (``decode_step_paged``) and the paged
multi-position verify of the speculative plane (``verify_step_paged``).
With ``kv_cache_dtype="int8"`` the caches and page pools hold int8 K/V
with a float32 scale per (position, kv head) (``_quant_kv``, round half to
even as ``jnp.round``); each decode or verify step dequantizes a dense view
of the layer's cache (for the pools, the block table's pages gathered) and
attends over it with the dense-cache kernels, as the reference does: its
fused paged kernel path is bf16-only.
The parameter layout is the reference's:
``params["segs"][si][j]`` holds the stacked ``(count, ...)`` leaves of
pattern position j of segment si (``plan.layer_plan``), so a JAX parameter
tree carries across unchanged (``repro_torch.convert``).  A Python loop over
the layers takes the place of ``lax.scan``.

Not ported yet: the MoE, hybrid-SSM and xLSTM blocks, cross-attention and
the training loss; their configs raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.common import ParamDecl, default_device, init_params
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ref import gather_pages
from .attention import attention_block, attn_decls, project_kv_token
from .layers import (embed_decls, embed_lookup, logits_for, mlp, mlp_decls,
                     norm_decl, rms_norm)
from .plan import LayerKind, layer_plan


def _stack(decls, count: int):
    if isinstance(decls, ParamDecl):
        return ParamDecl((count,) + decls.shape, decls.init, decls.scale,
                         decls.dtype)
    return {k: _stack(v, count) for k, v in decls.items()}


def _layer(stacked, i: int):
    """Layer ``i`` of a tree of stacked ``(count, ...)`` leaves (views)."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def _layer_decls(cfg: ModelConfig, kind: LayerKind) -> dict:
    dt = cfg.dtype
    return {
        "ln1": norm_decl(cfg.d_model, dt),
        "attn": attn_decls(cfg),
        "ln2": norm_decl(cfg.d_model, dt),
        "ffn": mlp_decls(cfg.d_model, cfg.dense_d_ff or cfg.d_ff, dt),
    }


def _ffn_residual(cfg: ModelConfig, params: dict, x: torch.Tensor
                  ) -> torch.Tensor:
    """Post-attention tail shared by the full-sequence and paged decode
    paths: ln2 + dense FFN residual."""
    f = rms_norm(x, params["ln2"], cfg.norm_eps)
    return x + mlp(params["ffn"], f)


def _apply_layer(cfg: ModelConfig, kind: LayerKind, params: dict,
                 x: torch.Tensor, *, q_offset: int = 0):
    """Full-sequence layer.  Returns (x, {"k", "v"} of this layer)."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    a, (k, v) = attention_block(cfg, params["attn"], h, causal=True,
                                window=kind.window, q_offset=q_offset)
    return _ffn_residual(cfg, params, x + a), {"k": k, "v": v}


def _quant_kv(x: torch.Tensor):
    """(..., D) -> int8 values and a float32 scale per (...): the scale is
    max|x| over D (in float32, floored at 1e-8) over 127, and the values
    round half to even (``torch.round``, as ``jnp.round``), clipped to
    +-127."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(-1), min=1e-8)
    # a 0-d tensor on the device: on the card a Python divisor becomes a
    # multiply by its reciprocal, one ulp off the reference's division
    scale = amax / torch.full((), 127.0, device=xf.device)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _quant_leaves(cfg: ModelConfig, kv: dict) -> dict:
    """A layer's prefill ``{"k", "v"}`` as the cache stores them: as they
    are, or int8 with ``k_scale``/``v_scale``."""
    if cfg.kv_cache_dtype != "int8":
        return kv
    out = {}
    for key in ("k", "v"):
        out[key], out[f"{key}_scale"] = _quant_kv(kv[key])
    return out


def _write_kv(stacked: dict, i: int, index, k_new, v_new):
    """Write K/V at ``stacked[key][i][index]`` in place: as the cache's
    dtype, or quantized with their scales when the cache is int8."""
    if "k_scale" in stacked:
        (k_new, ks), (v_new, vs) = _quant_kv(k_new), _quant_kv(v_new)
        stacked["k_scale"][(i,) + index] = ks
        stacked["v_scale"][(i,) + index] = vs
    stacked["k"][(i,) + index] = k_new.to(stacked["k"].dtype)
    stacked["v"][(i,) + index] = v_new.to(stacked["v"].dtype)


def _dequant(cfg: ModelConfig, q: torch.Tensor, scale: torch.Tensor
             ) -> torch.Tensor:
    """int8 values times their scales, both in the config's dtype (the
    reference's rounding)."""
    return q.to(cfg.dtype) * scale.to(cfg.dtype)[..., None]


def _dense_view(cfg: ModelConfig, pools: dict, i: int,
                block_table: torch.Tensor) -> tuple:
    """Layer i's int8 pools gathered through the block table into a dense
    ``(B, P·PS, K, D)`` K and V, dequantized."""
    b, p = block_table.shape
    idx = block_table.long()
    out = []
    for key in ("k", "v"):
        vals = gather_pages(pools[key][i], block_table)
        scale = pools[f"{key}_scale"][i][idx].reshape(b, vals.shape[1], -1)
        out.append(_dequant(cfg, vals, scale))
    return tuple(out)


def _decode_layer(cfg: ModelConfig, kind: LayerKind, params: dict,
                  x: torch.Tensor, stacked: dict, i: int, pos: int
                  ) -> torch.Tensor:
    """One decode layer against the dense cache: write this token's K/V
    column at (layer i, :, pos) of the stacked ``(count, B, T, K, D)``
    buffers, then attend over positions <= pos of every sequence (an int8
    cache: over the layer's buffers dequantized)."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    k_new, v_new = project_kv_token(cfg, params["attn"], h, pos)
    # in place, as the paged step writes its pages: the reference's
    # ``dynamic_update_slice`` on the scan carry writes one column too
    _write_kv(stacked, i, (slice(None), pos), k_new[:, 0], v_new[:, 0])
    if "k_scale" in stacked:
        lc = {"k": _dequant(cfg, stacked["k"][i], stacked["k_scale"][i]),
              "v": _dequant(cfg, stacked["v"][i], stacked["v_scale"][i]),
              "pos": pos}
    else:
        # stacked[i] is contiguous (the layer axis leads): the kernel takes it
        lc = {"k": stacked["k"][i], "v": stacked["v"][i], "pos": pos}
    a, _ = attention_block(cfg, params["attn"], h, causal=True,
                           window=kind.window, cache=lc, prewritten=True)
    return _ffn_residual(cfg, params, x + a)


def _decode_layer_paged(cfg: ModelConfig, kind: LayerKind, params: dict,
                        x: torch.Tensor, pools: dict, i: int,
                        block_table: torch.Tensor, lens: torch.Tensor
                        ) -> torch.Tensor:
    """One decode layer over the paged state: write this token's K/V into
    its page slot (block_table[b, lens[b] // PS], lens[b] % PS) of layer i's
    pools, then attend through the block table (int8 pools: over their
    dequantized dense view, with the dense-cache kernel)."""
    k_pool, v_pool = pools["k"], pools["v"]          # (L, n_pages, PS, K, D)
    page_size = k_pool.shape[2]
    p_max = block_table.shape[1]
    pg = (lens // page_size).long()
    # a finished row may sit at lens == P·PS: the reference drops its
    # out-of-range write, here it lands on the dump page
    pidx = torch.where(
        pg < p_max,
        block_table.gather(1, pg.clamp(max=p_max - 1)[:, None])[:, 0], 0)
    off = (lens % page_size).long()
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    k_new, v_new = project_kv_token(cfg, params["attn"], h, lens)
    # in place (index_put_): the reference's functional ``.at[i, pidx,
    # off].set`` is cheap only because XLA donates the buffer; an
    # out-of-place scatter here would copy the whole stacked pool, ~3 GB
    # per layer per token at the serving shapes
    _write_kv(pools, i, (pidx.long(), off), k_new[:, 0], v_new[:, 0])
    if "k_scale" in pools:
        kd, vd = _dense_view(cfg, pools, i, block_table)
        lc = {"k": kd, "v": vd, "pos": lens}
    else:
        # pool[i] is contiguous (the layer axis leads): the kernel takes it
        lc = {"k_pages": k_pool[i], "v_pages": v_pool[i],
              "block_table": block_table, "pos": lens}
    a, _ = attention_block(cfg, params["attn"], h, causal=True,
                           window=kind.window, cache=lc, prewritten=True)
    return _ffn_residual(cfg, params, x + a)


def _verify_layer_paged(cfg: ModelConfig, kind: LayerKind, params: dict,
                        x: torch.Tensor, pools: dict, i: int,
                        block_table: torch.Tensor, lens: torch.Tensor
                        ) -> torch.Tensor:
    """Speculative-verify twin of :func:`_decode_layer_paged`: ``x`` carries
    S tokens per sequence at positions ``lens[b] .. lens[b]+S-1``.  All S
    K/V columns are written into layer i's pools in place, then ONE
    multi-position attention pass scores every position (query s masked to
    positions <= lens[b]+s).  Recurrent layers advance token by token and
    cannot be batch-verified."""
    if kind.block != "attn":
        raise NotImplementedError(
            "speculative verify requires pure-attention layers; "
            f"got {kind.block!r}")
    k_pool, v_pool = pools["k"], pools["v"]          # (L, n_pages, PS, K, D)
    page_size = k_pool.shape[2]
    p_max = block_table.shape[1]
    s_q = x.shape[1]
    pos2 = lens[:, None] + torch.arange(s_q, dtype=lens.dtype,
                                        device=lens.device)[None, :]
    pg = (pos2 // page_size).long()
    # past the block table (never on the serving path) -> the dump page
    pidx = torch.where(pg < p_max,
                       block_table.gather(1, pg.clamp(max=p_max - 1)), 0)
    off = (pos2 % page_size).long()
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    k_new, v_new = project_kv_token(cfg, params["attn"], h, lens)
    # in place, as the decode step; masked rows (block table 0) all write
    # the dump page, duplicates included: nothing valid ever reads it
    _write_kv(pools, i, (pidx.long(), off), k_new, v_new)
    if "k_scale" in pools:
        kd, vd = _dense_view(cfg, pools, i, block_table)
        lc = {"k": kd, "v": vd, "pos": lens}
    else:
        lc = {"k_pages": k_pool[i], "v_pages": v_pool[i],
              "block_table": block_table, "pos": lens}
    a, _ = attention_block(cfg, params["attn"], h, causal=True,
                           window=kind.window, cache=lc, prewritten=True)
    return _ffn_residual(cfg, params, x + a)


def _logits_f32(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """float32 logits of the rows of ``h`` (..., d) against the vocabulary
    table.  The reference keeps them unrounded (``preferred_element_type=
    f32``); on the card a bf16 table goes into the product as is, with
    float32 output: widening it first would write and read a float32 copy
    of the table every step (~0.5 GB at 32000 x 3840)."""
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    if table.is_cuda and table.dtype != torch.float32:
        out = torch.mm(h2, table.t(), out_dtype=torch.float32)
    else:
        out = h2.float() @ table.float().t()
    return out.reshape(*lead, -1)


class DecoderLM:
    """Dense decoder language model (sliding-window and local:global
    attention patterns included)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.plan = layer_plan(cfg)
        for _, pattern in self.plan:
            for kind in pattern:
                if kind.block != "attn" or kind.is_moe:
                    raise NotImplementedError(
                        f"{cfg.name}: layer block {kind.block!r} (moe="
                        f"{kind.is_moe}) is not ported yet")

    # -- declarations --------------------------------------------------
    def decls(self) -> dict:
        cfg = self.cfg
        d = {
            "embed": embed_decls(cfg.padded_vocab, cfg.d_model, cfg.dtype),
            "final_norm": norm_decl(cfg.d_model, cfg.dtype),
            "segs": [[_stack(_layer_decls(cfg, k), count) for k in pattern]
                     for count, pattern in self.plan],
        }
        if not cfg.tie_embeddings:
            d["out_embed"] = embed_decls(cfg.padded_vocab, cfg.d_model,
                                         cfg.dtype)
        return d

    def init(self, seed: int = 0, device=None):
        """Random weights drawn on ``device`` from a generator of that
        device seeded with ``seed``."""
        device = default_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_params(self.decls(), gen, device)

    def _out_table(self, params):
        return params.get("out_embed", params["embed"])

    def _layers(self, params):
        """(kind, layer params, pattern index j, segment index si, layer i)
        in stack order."""
        for si, (count, pattern) in enumerate(self.plan):
            for i in range(count):
                for j, kind in enumerate(pattern):
                    yield kind, _layer(params["segs"][si][j], i), si, j, i

    # -- full-sequence forward ------------------------------------------
    def hidden(self, params, tokens: torch.Tensor, q_offset: int = 0):
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens)
        for kind, lp, *_ in self._layers(params):
            x, _ = _apply_layer(cfg, kind, lp, x, q_offset=q_offset)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    def logits(self, params, tokens: torch.Tensor) -> torch.Tensor:
        h = self.hidden(params, tokens)
        return logits_for(self._out_table(params), h).float()

    # -- caches -------------------------------------------------------------
    def _kv_buffers(self, count: int, lead: tuple, device) -> dict:
        """One pattern position's zeroed K/V buffers ``(count, *lead, K,
        D)``: in the config's dtype, or int8 with float32 ``k_scale`` /
        ``v_scale`` ``(count, *lead, K)``."""
        cfg = self.cfg
        shape = (count,) + lead + (cfg.n_kv_heads,)
        int8 = cfg.kv_cache_dtype == "int8"
        out = {key: torch.zeros(shape + (cfg.hd,),
                                dtype=torch.int8 if int8 else cfg.dtype,
                                device=device) for key in ("k", "v")}
        if int8:
            for key in ("k_scale", "v_scale"):
                out[key] = torch.zeros(shape, dtype=torch.float32,
                                       device=device)
        return out

    def empty_cache(self, batch: int, t_max: int, device=None) -> dict:
        """Dense decode cache: per pattern position, K and V buffers
        ``(count, batch, t_max, K, D)`` (int8: with their scales) and the
        shared position ``pos``."""
        device = default_device(device)
        return {"pos": 0, "segs": [
            [self._kv_buffers(count, (batch, t_max), device)
             for _ in pattern]
            for count, pattern in self.plan]}

    def empty_paged_state(self, n_slots: int, n_pages: int, page_size: int,
                          device=None) -> dict:
        """Fixed-shape serving state: per pattern position, K and V page
        pools ``(count, n_pages, page_size, K, D)`` (int8: with their
        scales) shared by every slot (``n_slots`` is part of the
        reference's signature; attention-only models keep no per-slot
        state)."""
        device = default_device(device)
        return {"segs": [
            [self._kv_buffers(count, (n_pages, page_size), device)
             for _ in pattern]
            for count, pattern in self.plan]}

    # -- prefill: build the cache over a prompt -----------------------------
    def prefill(self, params, tokens: torch.Tensor):
        """tokens (B, S).  Returns (cache, float32 logits of the last
        position): cache ``{"pos": S, "segs": [[{"k", "v"} of shape
        (count, B, S, K, D)]]}`` (int8: with ``k_scale``/``v_scale`` of
        shape (count, B, S, K))."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens)
        per_layer: dict = {}
        for kind, lp, si, j, _ in self._layers(params):
            x, kv = _apply_layer(cfg, kind, lp, x)
            per_layer.setdefault((si, j), []).append(_quant_leaves(cfg, kv))
        segs = [[{key: torch.stack([kv[key] for kv in per_layer[(si, j)]])
                  for key in per_layer[(si, j)][0]}
                 for j in range(len(pattern))]
                for si, (_, pattern) in enumerate(self.plan)]
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = logits_for(self._out_table(params), h[:, -1]).float()
        return {"pos": tokens.shape[1], "segs": segs}, logits

    # -- dense-cache single-token decode -------------------------------------
    def decode_step(self, params, cache: dict, token: torch.Tensor):
        """token (B,1) int32; cache from ``prefill`` grown by
        ``zoo.pad_cache`` (or ``empty_cache``), ``pos`` a Python int shared
        by the batch.  Writes the token's K/V at position pos of every
        layer's buffers IN PLACE and returns ({"pos": pos + 1, "segs"},
        float32 logits (B, V_padded)).  ``pos`` never leaves the host, so
        the step reads nothing back from the device."""
        cfg = self.cfg
        pos = int(cache["pos"])
        x = embed_lookup(params["embed"], token)
        for kind, lp, si, j, i in self._layers(params):
            x = _decode_layer(cfg, kind, lp, x, cache["segs"][si][j], i, pos)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)[:, -1]
        return ({"pos": pos + 1, "segs": cache["segs"]},
                _logits_f32(h, self._out_table(params)))

    # -- paged single-token decode -------------------------------------------
    def decode_step_paged(self, params, state: dict, token: torch.Tensor,
                          block_table: torch.Tensor, lens: torch.Tensor):
        """token (B,1) int32; block_table (B,P) int32 physical page ids;
        lens (B,) int32 tokens already in the cache.  Writes the token's K/V
        at position lens[b] of every layer's pools IN PLACE and returns
        (state, float32 logits (B, V_padded)); the caller advances lens."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], token)
        for kind, lp, si, j, i in self._layers(params):
            x = _decode_layer_paged(cfg, kind, lp, x, state["segs"][si][j], i,
                                    block_table, lens)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)[:, -1]
        return state, _logits_f32(h, self._out_table(params))

    # -- paged multi-position verify (speculative cascade) --------------------
    def verify_step_paged(self, params, state: dict, tokens: torch.Tensor,
                          block_table: torch.Tensor, lens: torch.Tensor):
        """tokens (B,S) int32 — token s is the input at position lens[b]+s
        (its K/V is written there, in place); block_table (B,P); lens (B,)
        int32.  Returns (state, float32 logits (B,S,V_padded)): logits[:, s]
        scores the token FOLLOWING position lens+s."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens)
        for kind, lp, si, j, i in self._layers(params):
            x = _verify_layer_paged(cfg, kind, lp, x, state["segs"][si][j], i,
                                    block_table, lens)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return state, _logits_f32(h, self._out_table(params))
