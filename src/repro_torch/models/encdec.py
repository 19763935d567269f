"""Encoder-decoder LM (the seamless-m4t family).

The port of ``repro.models.encdec``.  The encoder takes frontend
embeddings (audio frames: the reference's modality stub gives them
precomputed) through non-causal self-attention layers (RoPE on, as in the
reference) and a final norm; the decoder is causal, with cross-attention
into the encoder's output in every layer.  Both reuse the layer blocks of
:mod:`transformer` (``enc`` and ``xdec``).  The entry points are the
reference's: ``encode``, ``hidden``, ``logits``, ``loss``, ``prefill``
(whose cache holds each decoder layer's encoder K/V ``ck``/``cv`` beside
the self-attention K/V) and the inherited dense-cache ``decode_step``.  No
engine serves the family (neither the reference's ``Endpoint`` nor its
``RestartEndpoint`` can), and it has no paged state.
"""
from __future__ import annotations

import torch

from repro_torch.common import default_device
from repro_torch.configs.base import ModelConfig
from .layers import (chunked_softmax_xent, embed_decls, embed_lookup,
                     norm_decl, rms_norm)
from .plan import LayerKind
from .transformer import DecoderLM, _layer_decls, _run_stack, _stack


class EncDecLM(DecoderLM):
    def __init__(self, cfg: ModelConfig):
        assert cfg.n_enc_layers > 0
        self.cfg = cfg
        self.enc_plan = [(cfg.n_enc_layers, (LayerKind(block="enc"),))]
        self.plan = [(cfg.n_layers, (LayerKind(block="xdec"),))]

    def decls(self) -> dict:
        """The reference's tree: no ``out_embed`` (the LM head falls back to
        ``embed``, whatever ``tie_embeddings`` says)."""
        cfg = self.cfg

        def segs(plan):
            return [[_stack(_layer_decls(cfg, k), count) for k in pattern]
                    for count, pattern in plan]

        return {
            "embed": embed_decls(cfg.padded_vocab, cfg.d_model),
            "enc_norm": norm_decl(cfg.d_model),
            "final_norm": norm_decl(cfg.d_model),
            "enc_segs": segs(self.enc_plan),
            "segs": segs(self.plan),
        }

    # -- encoder ------------------------------------------------------------
    def encode(self, params, embeds: torch.Tensor) -> torch.Tensor:
        """embeds (B, S_enc, d) -> the encoder's memory (B, S_enc, d)."""
        cfg = self.cfg
        layers = self._layers(params, "enc_segs", self.enc_plan)
        x = _run_stack(cfg, layers, embeds.to(cfg.dtype))
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    # -- decoder over the encoder's memory ------------------------------------
    def _dec_hidden(self, params, tokens, memory):
        cfg = self.cfg
        x = _run_stack(cfg, self._layers(params),
                       embed_lookup(params["embed"], tokens),
                       enc_memory=memory)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    def hidden(self, params, tokens=None, embeds=None, q_offset: int = 0):
        return self._dec_hidden(params, tokens, self.encode(params, embeds))

    def loss(self, params, batch: dict) -> torch.Tensor:
        """Mean next-token NLL of the decoder tokens (B, S) over the
        encoder's frames ``batch["embeds"]``: labels by roll, positions 0 ..
        S - 2."""
        cfg = self.cfg
        tokens = batch["tokens"]
        h = self.hidden(params, tokens, batch["embeds"])
        b, s, _ = h.shape
        labels = torch.roll(tokens, -1, dims=1)
        mask = (torch.arange(s, device=h.device) < s - 1)[None, :].expand(b, s)
        return chunked_softmax_xent(self._out_table(params), h, labels, mask,
                                    cfg.vocab_size, cfg.logit_chunk)

    # -- prefill / decode ------------------------------------------------------
    def prefill(self, params, tokens=None, embeds=None):
        """tokens (B, S_dec), embeds (B, S_enc, d).  Returns (cache, float32
        logits of the last position): cache ``{"pos": S_dec, "segs":
        [[{"k", "v": (L, B, S_dec, K, D), "ck", "cv": (L, B, S_enc, K,
        D)}]]}``.  ``zoo.pad_cache`` grows ``k``/``v`` only."""
        memory = self.encode(params, embeds)
        return self._prefill_layers(params,
                                    embed_lookup(params["embed"], tokens),
                                    enc_memory=memory)

    def empty_cache(self, batch: int, t_max: int, enc_len: int = 0,
                    device=None) -> dict:
        """Zeroed self-attention K/V of ``t_max`` positions and encoder K/V
        of ``enc_len`` (``t_max`` when 0), ``(L, batch, ·, K, D)`` in the
        config's dtype."""
        cfg = self.cfg
        device = default_device(device)

        def zeros(t):
            return torch.zeros((cfg.n_layers, batch, t, cfg.n_kv_heads,
                                cfg.hd), dtype=cfg.dtype, device=device)

        seg = [{"k": zeros(t_max), "v": zeros(t_max),
                "ck": zeros(enc_len or t_max), "cv": zeros(enc_len or t_max)}]
        return {"pos": 0, "segs": [seg]}
