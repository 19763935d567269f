"""Speculative cascade plane: (draft, verify) pair columns for the solver
and the live acceptance-rate EWMAs that reprice them.

The port of ``repro.core.speculative``.  A pair column j >= M in the
solver's (N, M + P) matrices stands for "decode with ``pairs[j - M]``": the
weak endpoint drafts ``k`` tokens into its paged KV, the strong endpoint
verifies all of them in ONE batched multi-position paged step, and the
longest strong-matching prefix (plus the strong model's correction token)
is emitted.  Greedy speculative decode is output-identical to the verify
model alone, so a pair column carries

- predicted cost ``c_draft + c_verify / E[tokens accepted per round]``, and
- the VERIFY model's quality column unchanged.

``expand_pair_columns`` runs as tensor ops on the predictor's device: the
router splices it between predict and solve with no host round-trip, the
acceptance EWMA entering as a runtime ``(P,)`` tensor.
``AcceptanceTracker`` keeps its state on the host (NumPy), as in the
reference; callers read ``expected()``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

# a dead draft (nothing ever accepted) must not divide the verify cost by
# zero — the column price saturates instead, and the solver routes around it
ACC_EPS = 0.25


@dataclasses.dataclass(frozen=True)
class SpecPair:
    """One (draft, verify) column: indices into the base model axis."""
    draft: int
    verify: int
    k: int = 4          # draft tokens per verify round

    def __post_init__(self):
        if self.draft == self.verify:
            raise ValueError("draft and verify must be distinct endpoints")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")


class AcceptanceTracker:
    """Per-pair EWMA of tokens emitted per verify round (in [1, k]).

    Every verify round emits at least the strong model's correction token,
    so the EWMA lives in [1, k]; it starts at the midpoint and folds each
    round's ``n_emit`` in with weight ``1 - beta``."""

    def __init__(self, pairs: Sequence[SpecPair], *, beta: float = 0.8):
        self.pairs = tuple(pairs)
        self.beta = float(beta)
        self._ewma = np.array([(1.0 + p.k) / 2.0 for p in self.pairs],
                              np.float64)
        self.rounds = np.zeros(len(self.pairs), np.int64)

    def record(self, pair: int, n_emit: float) -> None:
        """Fold one verify round's emitted-token count into pair ``pair``."""
        k = self.pairs[pair].k
        n = min(max(float(n_emit), 1.0), float(k))
        self._ewma[pair] = self.beta * self._ewma[pair] + (1 - self.beta) * n
        self.rounds[pair] += 1

    def expected(self) -> np.ndarray:
        """(P,) expected accepted tokens per round — the pair-cost divisor."""
        return np.maximum(self._ewma.copy(), ACC_EPS)


def pair_index_arrays(pairs: Sequence[SpecPair]) -> Tuple[tuple, tuple]:
    """(draft_idx, verify_idx) tuples for ``expand_pair_columns``."""
    return (tuple(p.draft for p in pairs), tuple(p.verify for p in pairs))


def expand_pair_columns(cost, quality, draft_idx, verify_idx, e_acc):
    """(N, M) predict outputs -> (N, M + P) solver inputs, on their device.

    Pair column p costs ``cost[:, d_p] + cost[:, v_p] / e_acc[p]`` and
    carries the verify model's quality column.  P = 0 returns the inputs
    unchanged."""
    if len(draft_idx) == 0:
        return cost, quality
    dev = cost.device
    d = torch.as_tensor(draft_idx, dtype=torch.long, device=dev)
    v = torch.as_tensor(verify_idx, dtype=torch.long, device=dev)
    e = torch.clamp(torch.as_tensor(e_acc, dtype=cost.dtype, device=dev),
                    min=ACC_EPS)
    c_pair = cost[:, d] + cost[:, v] / e[None, :]
    q_pair = quality[:, v]
    return (torch.cat([cost, c_pair], dim=1),
            torch.cat([quality, q_pair], dim=1))
