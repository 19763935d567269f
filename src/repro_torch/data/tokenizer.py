"""Deterministic hash tokenizer for the routing predictor (no external vocab).

A verbatim copy of ``repro.data.tokenizer``: token ids are bit-identical
(``tests/test_torch_boundary.py`` holds the two equal)."""
from __future__ import annotations

import hashlib
from typing import List

import numpy as np

VOCAB = 8192
PAD, CLS = 0, 1


def _tok(word: str) -> int:
    h = int(hashlib.md5(word.encode()).hexdigest()[:8], 16)
    return 2 + (h % (VOCAB - 2))


def encode(text: str, max_len: int = 64) -> np.ndarray:
    ids = [CLS] + [_tok(w) for w in text.lower().split()][: max_len - 1]
    ids = ids + [PAD] * (max_len - len(ids))
    return np.array(ids, dtype=np.int32)


def encode_batch(texts: List[str], max_len: int = 64) -> np.ndarray:
    return np.stack([encode(t, max_len) for t in texts])


def encode_for_config(cfg, text: str, max_len: int = 64) -> np.ndarray:
    """Encode for a *model* (not the router): strip padding and remap ids
    into the config's vocab so smoke-sized models (vocab 512) can decode
    router-tokenized text.  Ids already in range are kept verbatim; the
    rest wrap into [2, vocab) so PAD/CLS stay reserved.  Callers serving a
    heterogeneous pool should pass the smallest-vocab config."""
    vocab = int(cfg.vocab_size)
    if vocab < 3:
        raise ValueError(f"config vocab_size={vocab} leaves no room for "
                         "PAD/CLS + content ids")
    toks = encode(text, max_len)
    toks = toks[toks != PAD]
    return np.where(toks < vocab, toks, 2 + toks % (vocab - 2)).astype(
        np.int32)
