"""Causal / sliding-window GQA flash attention (every full-sequence
attention: prefill, ``hidden``, ``logits``)."""
