"""Decoder LM of the dense, MoE, hybrid-SSM (hymba) and xLSTM families,
and the layer blocks the encoder-decoder (``encdec.EncDecLM``) shares.

The port of ``repro.models.transformer.DecoderLM`` on the paths the serving
planes run: the full-sequence forward (``hidden``/``logits``), ``prefill``
(which returns the KV cache and the recurrent state), the dense-cache
single-token decode (``empty_cache``, ``decode_step``: the restart-batching
baseline), the paged single-token decode (``decode_step_paged``) and the
paged multi-position verify of the speculative plane
(``verify_step_paged``, attention layers only: a recurrent layer raises, as
in the reference).  A layer is an attention block with a gated MLP or a
mixture-of-experts FFN (``moe.moe_block``, where ``kind.is_moe``), a
hymba block (attention in parallel with SSD heads, then the MLP), an mLSTM
or an sLSTM block (``plan.layer_plan``); the encoder-decoder adds the
non-causal ``enc`` block and the ``xdec`` block (self-attention, then
cross-attention into the encoder's memory, then the FFN), whose caches
hold the encoder K/V ``ck``/``cv`` beside the self-attention K/V and have
no paged form (as in the reference).  ``hidden``, ``logits`` and
``prefill`` take frame or patch embeddings (``embeds``, cast to the
config's dtype) put before the token embeddings, as the reference's
``_embed_input``.  The page pools hold the attention
K/V; the recurrent state (hymba's SSD state and convolution tail, the
mLSTM's matrix memory, the sLSTM's cell) is kept per slot, ``(count,
n_slots, ...)``, beside them.
With ``kv_cache_dtype="int8"`` the caches and page pools of the attention
layers (``kind.block == "attn"``; hymba's K/V stay in the model dtype, as
in the reference) hold int8 K/V with a float32 scale per (position, kv
head) (``_quant_kv``, round half to even as ``jnp.round``); each decode or
verify step dequantizes a dense view of the layer's cache (for the pools,
the block table's pages gathered) and attends over it with the dense-cache
kernels, as the reference does: its fused paged kernel path is bf16-only.
The parameter layout is the reference's:
``params["segs"][si][j]`` holds the stacked ``(count, ...)`` leaves of
pattern position j of segment si (``plan.layer_plan``), so a JAX parameter
tree carries across unchanged (``repro_torch.convert``).  A Python loop over
the layers takes the place of ``lax.scan``; each stacked leaf is unbound
into its layers once per pass, so a gradient stacks the layers' gradients
once.  The training loss (``loss``: labels by roll, the chunked-vocabulary
cross-entropy) runs ``hidden`` under autograd; with ``cfg.remat != "none"``
each layer body runs under ``torch.utils.checkpoint`` there (the
reference's ``jax.checkpoint`` of the scan body), and not where no
gradient is taken.
"""
from __future__ import annotations

from typing import List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import ParamDecl, default_device, init_params
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ref import gather_pages
from .attention import attention_block, attn_decls, project_kv_token
from .hymba_block import hymba_decls, hymba_layer
from .layers import (embed_decls, embed_lookup, logits_for, mlp, mlp_decls,
                     norm_decl, rms_norm, xent_sums)
from .moe import moe_block, moe_decls
from .plan import LayerKind, layer_plan
from .xlstm_blocks import _dims as xlstm_dims
from .xlstm_blocks import mlstm_block, mlstm_decls, slstm_block, slstm_decls


def _stack(decls, count: int):
    if isinstance(decls, ParamDecl):
        return ParamDecl((count,) + decls.shape, ("p_layers",) + decls.logical,
                         decls.init, decls.scale, decls.dtype)
    return {k: _stack(v, count) for k, v in decls.items()}


def _unbind(stacked, count: int) -> list:
    """The ``count`` layers of a tree of stacked ``(count, ...)`` leaves,
    each a tree of views (``unbind``: under autograd the layers' gradients
    are stacked once, not scattered into a zeroed stack per layer)."""
    if isinstance(stacked, dict):
        per = {k: _unbind(v, count) for k, v in stacked.items()}
        return [{k: per[k][i] for k in per} for i in range(count)]
    return list(stacked.unbind(0))


class LayerHooks:
    """Identity hooks of the full-sequence forward.  ``layer`` maps the
    parameters of the layer at pattern position j of segment si just
    before the layer uses them (inside its remat checkpoint, so what it
    makes is freed after the forward and made again in the backward);
    ``to_model`` and ``from_model`` wrap the input and the output of a
    dense layer's attention and MLP; ``moe`` computes a MoE layer's FFN
    (``moe.moe_block``).  The sharded train step (``training.sharded``)
    overrides them with its FSDP gathers, its tensor-parallel collectives
    and its expert-parallel body."""

    def layer(self, params: dict, si: int, j: int) -> dict:
        return params

    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def from_model(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def moe(self, cfg: ModelConfig, params: dict, x: torch.Tensor
            ) -> torch.Tensor:
        return moe_block(cfg, params, x)


_NO_HOOKS = LayerHooks()


def _layer_out(cfg: ModelConfig, kind: LayerKind, params: dict,
               x: torch.Tensor, q_offset: int = 0, enc_memory=None,
               hooks: LayerHooks = _NO_HOOKS, where: tuple = (0, 0)
               ) -> torch.Tensor:
    """A full-sequence layer's output alone (the cache dropped); ``where``
    is the layer's (segment, pattern position) for ``hooks.layer``."""
    return _apply_layer(cfg, kind, hooks.layer(params, *where), x,
                        q_offset=q_offset, enc_memory=enc_memory,
                        hooks=hooks)[0]


def _leaf_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaf_tensors(v)]
    return [tree]


def _run_stack(cfg: ModelConfig, layers, x: torch.Tensor, **kw
               ) -> torch.Tensor:
    """x through ``layers`` (``DecoderLM._layers``' tuples in stack
    order).  Under autograd with ``cfg.remat != "none"`` each layer body
    that takes a gradient runs under ``checkpoint`` (its activations
    recomputed in the backward)."""
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for kind, lp, si, j, _ in layers:
        if remat and (x.requires_grad or any(
                t.requires_grad for t in _leaf_tensors(lp))):
            x = checkpoint(_layer_out, cfg, kind, lp, x, use_reentrant=False,
                           where=(si, j), **kw)
        else:
            x = _layer_out(cfg, kind, lp, x, where=(si, j), **kw)
    return x


def _layer_decls(cfg: ModelConfig, kind: LayerKind) -> dict:
    if kind.block == "mlstm":
        return {"mlstm": mlstm_decls(cfg)}
    if kind.block == "slstm":
        return {"slstm": slstm_decls(cfg)}
    if kind.block == "hymba":
        return {
            "hymba": hymba_decls(cfg),
            "ln2": norm_decl(cfg.d_model),
            "ffn": mlp_decls(cfg.d_model, cfg.d_ff),
        }
    d = {
        "ln1": norm_decl(cfg.d_model),
        "attn": attn_decls(cfg),
        "ln2": norm_decl(cfg.d_model),
        "ffn": (moe_decls(cfg) if kind.is_moe else
                mlp_decls(cfg.d_model, cfg.dense_d_ff or cfg.d_ff)),
    }
    if kind.block == "xdec":
        d["ln_cross"] = norm_decl(cfg.d_model)
        d["cross"] = attn_decls(cfg)
    return d


def _ffn_residual(cfg: ModelConfig, kind: LayerKind, params: dict,
                  x: torch.Tensor, hooks: LayerHooks = _NO_HOOKS
                  ) -> torch.Tensor:
    """Post-attention tail shared by the full-sequence and decode paths:
    ln2 + (MoE or dense) FFN residual."""
    f = rms_norm(x, params["ln2"], cfg.norm_eps)
    if kind.is_moe:
        return x + hooks.moe(cfg, params["ffn"], f)
    return x + hooks.from_model(mlp(params["ffn"], hooks.to_model(f)))


def _cross(cfg: ModelConfig, params: dict, x: torch.Tensor, **kw):
    """The xdec block's cross-attention branch: ln_cross, then non-causal
    attention without RoPE into the encoder's memory (``kv_x``) or its
    cached K/V (``cache``, ``cross_cached``).  Returns (out, new_kv)."""
    h = rms_norm(x, params["ln_cross"], cfg.norm_eps)
    return attention_block(cfg, params["cross"], h, causal=False,
                           use_rope=False, **kw)


def _apply_layer(cfg: ModelConfig, kind: LayerKind, params: dict,
                 x: torch.Tensor, *, q_offset: int = 0, enc_memory=None,
                 hooks: LayerHooks = _NO_HOOKS):
    """Full-sequence layer.  Returns (x, this layer's cache: {"k", "v"} of
    an attention layer, with hymba's {"s", "conv"} and an xdec layer's
    encoder K/V {"ck", "cv"} (cross-attention into ``enc_memory``); the
    recurrent blocks' final state).  ``hooks`` wraps the attention and
    the dense MLP of an attention layer (``LayerHooks``)."""
    if kind.block == "mlstm":
        out, st = mlstm_block(cfg, params["mlstm"], x)
        return x + out, st
    if kind.block == "slstm":
        out, st = slstm_block(cfg, params["slstm"], x)
        return x + out, st
    if kind.block == "hymba":
        out, ((k, v), ssm) = hymba_layer(cfg, params["hymba"], x,
                                         window=kind.window,
                                         q_offset=q_offset)
        return (_ffn_residual(cfg, kind, params, x + out),
                {"k": k, "v": v, **ssm})
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    a, (k, v) = attention_block(cfg, params["attn"], hooks.to_model(h),
                                causal=kind.block != "enc",
                                window=kind.window, q_offset=q_offset)
    x = x + hooks.from_model(a)
    cache = {"k": k, "v": v}
    if kind.block == "xdec":
        ca, (cache["ck"], cache["cv"]) = _cross(cfg, params, x,
                                                kv_x=enc_memory)
        x = x + ca
    return _ffn_residual(cfg, kind, params, x, hooks), cache


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


def _int8_kv(cfg: ModelConfig, kind: LayerKind) -> bool:
    """Whether the layer's K/V are stored int8: attention layers of an
    int8-KV config only (hymba's stay in the model dtype)."""
    return cfg.kv_cache_dtype == "int8" and kind.block == "attn"


def _quant_leaves(cfg: ModelConfig, kind: LayerKind, cache: dict) -> dict:
    """A layer's prefill cache as the cache stores it: as it is, or with
    int8 ``k``/``v`` and their ``k_scale``/``v_scale``."""
    if not _int8_kv(cfg, kind):
        return cache
    out = dict(cache)
    for key in ("k", "v"):
        out[key], out[f"{key}_scale"] = _quant_kv(cache[key])
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


def _write_state(stacked: dict, i: int, new: dict):
    """Write a recurrent layer's new state into layer i of its stacked
    per-sequence buffers, in place."""
    for key, val in new.items():
        stacked[key][i] = val


def _attn_params(kind: LayerKind, params: dict) -> tuple:
    """(pre-attention norm weight, attention parameters) of an attention
    or hymba layer."""
    if kind.block == "hymba":
        return params["hymba"]["norm"], params["hymba"]["attn"]
    return params["ln1"], params["attn"]


def _finish_layer(cfg: ModelConfig, kind: LayerKind, params: dict,
                  x: torch.Tensor, h: torch.Tensor, lc: dict, stacked: dict,
                  i: int) -> torch.Tensor:
    """The rest of a decode layer once its token's K/V are written:
    attention over ``lc`` (hymba: in parallel with the SSD heads, whose
    state is read from and written back to layer i of ``stacked``; xdec:
    then cross-attention over layer i's encoder K/V ``ck``/``cv``) and the
    FFN residual."""
    if kind.block == "hymba":
        lc = dict(lc, s=stacked["s"][i], conv=stacked["conv"][i])
        out, (_, ssm) = hymba_layer(cfg, params["hymba"], x,
                                    window=kind.window, cache=lc,
                                    prewritten=True)
        _write_state(stacked, i, ssm)
    else:
        out, _ = attention_block(cfg, params["attn"], h, causal=True,
                                 window=kind.window, cache=lc,
                                 prewritten=True)
        if kind.block == "xdec":
            x = x + out
            out, _ = _cross(cfg, params, x, cross_cached=True, cache={
                "k": stacked["ck"][i], "v": stacked["cv"][i]})
    return _ffn_residual(cfg, kind, params, x + out)


def _decode_recurrent(cfg: ModelConfig, kind: LayerKind, params: dict,
                      x: torch.Tensor, stacked: dict, i: int
                      ) -> torch.Tensor:
    """One mLSTM or sLSTM decode layer: its per-sequence state at layer i
    of ``stacked`` advances one token, in place."""
    keys = ("s", "conv") if kind.block == "mlstm" else ("c", "n", "h")
    block = mlstm_block if kind.block == "mlstm" else slstm_block
    out, new = block(cfg, params[kind.block], x,
                     state={key: stacked[key][i] for key in keys})
    _write_state(stacked, i, new)
    return x + out


def _decode_layer(cfg: ModelConfig, kind: LayerKind, params: dict,
                  x: torch.Tensor, stacked: dict, i: int, pos: int
                  ) -> torch.Tensor:
    """One decode layer against the dense cache: write this token's K/V
    column at (layer i, :, pos) of the stacked ``(count, B, T, K, D)``
    buffers, then attend over positions <= pos of every sequence (an int8
    cache: over the layer's buffers dequantized); a recurrent layer
    advances its state in place."""
    if kind.block in ("mlstm", "slstm"):
        return _decode_recurrent(cfg, kind, params, x, stacked, i)
    norm, attn = _attn_params(kind, params)
    h = rms_norm(x, norm, cfg.norm_eps)
    k_new, v_new = project_kv_token(cfg, attn, h, pos)
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
    return _finish_layer(cfg, kind, params, x, h, lc, stacked, i)


def _decode_layer_paged(cfg: ModelConfig, kind: LayerKind, params: dict,
                        x: torch.Tensor, pools: dict, i: int,
                        block_table: torch.Tensor, lens: torch.Tensor
                        ) -> torch.Tensor:
    """One decode layer over the paged state: write this token's K/V into
    its page slot (block_table[b, lens[b] // PS], lens[b] % PS) of layer i's
    pools, then attend through the block table (int8 pools: over their
    dequantized dense view, with the dense-cache kernel).  Recurrent state
    is per slot and advances as on the dense path."""
    if kind.block in ("mlstm", "slstm"):
        return _decode_recurrent(cfg, kind, params, x, pools, i)
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
    norm, attn = _attn_params(kind, params)
    h = rms_norm(x, norm, cfg.norm_eps)
    k_new, v_new = project_kv_token(cfg, attn, h, lens)
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
    return _finish_layer(cfg, kind, params, x, h, lc, pools, i)


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
    return _ffn_residual(cfg, kind, params, x + a)


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
    """Decoder language model: dense (sliding-window and local:global
    attention patterns included), MoE, hybrid-SSM and xLSTM."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.plan = layer_plan(cfg)

    # -- declarations --------------------------------------------------
    def decls(self) -> dict:
        cfg = self.cfg
        d = {
            "embed": embed_decls(cfg.padded_vocab, cfg.d_model),
            "final_norm": norm_decl(cfg.d_model),
            "segs": [[_stack(_layer_decls(cfg, k), count) for k in pattern]
                     for count, pattern in self.plan],
        }
        if not cfg.tie_embeddings:
            d["out_embed"] = embed_decls(cfg.padded_vocab, cfg.d_model)
        return d

    def init(self, seed: int = 0, device=None):
        """Random weights drawn on ``device`` from a generator of that
        device seeded with ``seed``."""
        device = default_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_params(self.decls(), gen, device)

    def _out_table(self, params):
        return params.get("out_embed", params["embed"])

    def _layers(self, params, key: str = "segs", plan=None):
        """(kind, layer params, segment index si, pattern index j, layer i)
        in stack order."""
        for si, (count, pattern) in enumerate(plan or self.plan):
            seg = [_unbind(params[key][si][j], count)
                   for j in range(len(pattern))]
            for i in range(count):
                for j, kind in enumerate(pattern):
                    yield kind, seg[j][i], si, j, i

    # -- embedding -------------------------------------------------------
    def _embed_input(self, params, tokens, embeds):
        """Frame or patch embeddings (B, F, d), cast to the config's dtype,
        before the token embeddings (B, S, d); either may be None."""
        parts = []
        if embeds is not None:
            parts.append(embeds.to(self.cfg.dtype))
        if tokens is not None:
            parts.append(embed_lookup(params["embed"], tokens))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    # -- full-sequence forward ------------------------------------------
    def hidden(self, params, tokens=None, embeds=None, q_offset: int = 0,
               hooks: LayerHooks = _NO_HOOKS):
        cfg = self.cfg
        x = self._embed_input(params, tokens, embeds)
        x = _run_stack(cfg, self._layers(params), x, q_offset=q_offset,
                       hooks=hooks)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    # -- training loss ----------------------------------------------------
    def loss(self, params, batch: dict) -> torch.Tensor:
        """Mean next-token NLL of ``batch`` {"tokens" (B, S) [, "embeds"
        (B, F, d)] [, "mask" (B, F + S)]}: labels are the tokens rolled by
        one (the frontend's F positions padded with 0 in front), scored at
        positions max(F - 1, 0) .. F + S - 2 where ``mask`` > 0."""
        h = self.hidden(params, batch["tokens"], batch.get("embeds"))
        tot, cnt = self.loss_sums(h, self._out_table(params), batch)
        return tot / torch.clamp(cnt, min=1.0)

    def loss_sums(self, h, table, batch: dict):
        """(NLL sum, scored positions) of ``loss`` over the final hidden
        states ``h`` and the LM head ``table`` (``layers.xent_sums``)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        embeds = batch.get("embeds")
        b, s, _ = h.shape
        flen = 0 if embeds is None else embeds.shape[1]
        padded = tokens if flen == 0 else torch.cat(
            [tokens.new_zeros((b, flen)), tokens], dim=1)
        labels = torch.roll(padded, -1, dims=1)
        posn = torch.arange(s, device=h.device)
        mask = (posn >= max(flen - 1, 0)) & (posn < s - 1)
        mask = mask[None, :].expand(b, s)
        if batch.get("mask") is not None:
            mask = mask & (batch["mask"] > 0)
        return xent_sums(table, h, labels, mask, cfg.vocab_size,
                         cfg.logit_chunk)

    def logits(self, params, tokens=None, embeds=None) -> torch.Tensor:
        h = self.hidden(params, tokens, embeds)
        return logits_for(self._out_table(params), h).float()

    # -- caches -------------------------------------------------------------
    def _buffers(self, kind: LayerKind, count: int, kv_lead: tuple,
                 n_seq: int, device) -> dict:
        """One pattern position's zeroed buffers: the K/V of an attention
        or hymba layer ``(count, *kv_lead, K, D)`` (in the config's dtype,
        or int8 with float32 ``k_scale``/``v_scale`` ``(count, *kv_lead,
        K)`` on an int8-KV attention layer) and the recurrent state of
        ``n_seq`` sequences ``(count, n_seq, ...)``: float32 except the
        convolution tails, as the reference."""
        cfg = self.cfg
        f32 = torch.float32

        def zeros(shape, dtype):
            return torch.zeros((count,) + shape, dtype=dtype, device=device)

        out = {}
        if kind.block in ("attn", "hymba"):
            int8 = _int8_kv(cfg, kind)
            shape = kv_lead + (cfg.n_kv_heads,)
            for key in ("k", "v"):
                out[key] = zeros(shape + (cfg.hd,),
                                 torch.int8 if int8 else cfg.dtype)
            if int8:
                for key in ("k_scale", "v_scale"):
                    out[key] = zeros(shape, f32)
        if kind.block == "hymba":
            h, p, n = cfg.n_heads, cfg.hd, cfg.ssm_state
            out["s"] = zeros((n_seq, h, n, p), f32)
            out["conv"] = zeros((n_seq, cfg.ssm_conv - 1, h * p), cfg.dtype)
        if kind.block == "mlstm":
            _, d_inner, h, dk, dv = xlstm_dims(cfg)
            out["s"] = zeros((n_seq, h, dk, dv + 1), f32)
            out["conv"] = zeros((n_seq, cfg.ssm_conv - 1, d_inner), cfg.dtype)
        if kind.block == "slstm":
            h = cfg.n_heads
            for key in ("c", "n", "h"):
                out[key] = zeros((n_seq, h, cfg.d_model // h), f32)
        return out

    def empty_cache(self, batch: int, t_max: int, device=None) -> dict:
        """Dense decode cache: per pattern position, K and V buffers
        ``(count, batch, t_max, K, D)`` (int8: with their scales), the
        recurrent state ``(count, batch, ...)``, and the shared position
        ``pos``."""
        device = default_device(device)
        return {"pos": 0, "segs": [
            [self._buffers(kind, count, (batch, t_max), batch, device)
             for kind in pattern]
            for count, pattern in self.plan]}

    def empty_paged_state(self, n_slots: int, n_pages: int, page_size: int,
                          device=None) -> dict:
        """Fixed-shape serving state: per pattern position, K and V page
        pools ``(count, n_pages, page_size, K, D)`` (int8: with their
        scales) shared by every slot, and the per-slot recurrent state
        ``(count, n_slots, ...)``."""
        device = default_device(device)
        if any(k.block == "xdec" for _, p in self.plan for k in p):
            raise NotImplementedError("paged decode does not cover enc-dec")
        return {"segs": [
            [self._buffers(kind, count, (n_pages, page_size), n_slots,
                           device)
             for kind in pattern]
            for count, pattern in self.plan]}

    # -- prefill: build the cache over a prompt -----------------------------
    def _prefill_layers(self, params, x, **kw):
        """Run ``x`` through the stack.  Returns (cache, float32 logits of
        the last position): the layers' caches stacked per pattern
        position, ``pos`` the sequence length."""
        cfg = self.cfg
        per_layer: dict = {}
        for kind, lp, si, j, _ in self._layers(params):
            x, lc = _apply_layer(cfg, kind, lp, x, **kw)
            per_layer.setdefault((si, j), []).append(
                _quant_leaves(cfg, kind, lc))
        segs = [[{key: torch.stack([lc[key] for lc in per_layer[(si, j)]])
                  for key in per_layer[(si, j)][0]}
                 for j in range(len(pattern))]
                for si, (_, pattern) in enumerate(self.plan)]
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = logits_for(self._out_table(params), h[:, -1]).float()
        return {"pos": x.shape[1], "segs": segs}, logits

    def prefill(self, params, tokens=None, embeds=None):
        """tokens (B, S), after ``embeds`` (B, F, d) when given.  Returns
        (cache, float32 logits of the last position): cache ``{"pos": F +
        S, "segs": [[{"k", "v"} of shape (count, B, F + S, K, D)]]}``
        (int8: with ``k_scale``/``v_scale`` of shape (count, B, F + S,
        K)); a recurrent layer's entry holds its final state ``(count, B,
        ...)`` (hymba: beside its K/V)."""
        return self._prefill_layers(
            params, self._embed_input(params, tokens, embeds))

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
