"""Layer plans: group a heterogeneous layer stack into scannable segments.

A *segment* is ``(count, pattern)`` where ``pattern`` is a list of
:class:`LayerKind` — the segment repeats the pattern ``count`` times and is
executed as one ``lax.scan`` with parameters stacked on a leading ``count``
dim. Remainder layers that don't fill a period become a trailing segment with
``count = 1``. This keeps HLO size O(patterns), not O(layers), for every arch.

A verbatim copy of ``repro.models.plan`` (the port loops over the segment
in Python but keeps the stacked layout, so parameter trees carry across
unchanged); ``tests/test_torch_boundary.py`` holds the two equal.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class LayerKind:
    block: str = "attn"       # attn | moe | mlstm | slstm | hymba | enc | xdec
    window: int = 0           # sliding window (0 = full)
    is_moe: bool = False


def _kind_for(cfg: ModelConfig, idx: int, *, block: str) -> LayerKind:
    if block in ("mlstm", "slstm"):
        return LayerKind(block=block)
    window = 0
    if cfg.sliding_window > 0 and not cfg.layer_is_global_attn(idx):
        window = cfg.sliding_window
    return LayerKind(block=block, window=window, is_moe=cfg.layer_is_moe(idx))


def layer_plan(cfg: ModelConfig, *, block: str = "attn") -> List[Tuple[int, Tuple[LayerKind, ...]]]:
    """Segments for the decoder stack (or encoder when block='enc')."""
    if cfg.family == "xlstm":
        kinds = [
            LayerKind(block="slstm")
            if cfg.slstm_every and (i % cfg.slstm_every) == cfg.slstm_every - 1
            else LayerKind(block="mlstm")
            for i in range(cfg.n_layers)
        ]
    else:
        blk = "hymba" if cfg.family == "hymba" else block
        kinds = [_kind_for(cfg, i, block=blk) for i in range(cfg.n_layers if block != "enc" else cfg.n_enc_layers)]

    # find the shortest period that tiles a prefix of the stack
    n = len(kinds)
    period = 1
    for p in range(1, n + 1):
        pat = kinds[:p]
        reps = n // p
        if reps >= 1 and all(kinds[i] == pat[i % p] for i in range(reps * p)):
            period = p
            break
    reps = n // period
    segments = [(reps, tuple(kinds[:period]))]
    rem = kinds[reps * period:]
    if rem:
        segments.append((1, tuple(rem)))
    return segments


def plan_layer_count(plan) -> int:
    return sum(c * len(p) for c, p in plan)
