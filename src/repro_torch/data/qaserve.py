"""SynthQAServe — synthetic reconstruction of the paper's QAServe dataset.

A NumPy-only copy of ``repro.data.qaserve``: the same seed gives the same
dataset, value for value (``tests/test_torch_boundary.py`` holds the two
equal), so both packages route the same queries.

The paper collects per-(query, model) correctness and output token length by
zero-shot prompting six open models on MMLU/GPQA/MATH-500/GSM8K. Offline we
generate the same *shape* of data from a latent-variable simulator with known
ground truth (DESIGN.md §5):

    correctness_ij ~ Bernoulli( sigmoid( k * (skill_j - difficulty_i)
                                         + <topic_i, affinity_j> ) )
    out_len_ij     ~ LogNormal( mu(verbosity_j, task_i) ), capped at 1024

The fleet mirrors the paper's: three scales of one family, two of another,
plus two long-output "reasoning" models (the DeepSeek-R1 effect). Costs use
params-proportional per-token prices, as the paper does for open models.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

TASKS = ("mmlu", "gpqa", "math500", "gsm8k")
# task mix from the paper's Table 7 (37/7/19/37)
TASK_P = (0.37, 0.073, 0.185, 0.372)
L_MAX = 1024  # paper caps output length at 1024 for bucketing


@dataclasses.dataclass(frozen=True)
class PoolModel:
    name: str
    skill: float           # latent ability
    verbosity: float       # mean log output length
    price_in: float        # $ per 1k input tokens (params-proportional)
    price_out: float       # $ per 1k output tokens
    arch: Optional[str] = None   # assigned architecture backing this endpoint


# Mirrors the paper's fleet ordering: Qwen-2.5 7B/14B/32B, Llama-3.1-8B,
# DeepSeek-R1 7B/14B. Prices follow the LiteLLM open-model map shape.
DEFAULT_POOL: List[PoolModel] = [
    PoolModel("qwen-7b", skill=0.20, verbosity=4.4, price_in=0.00030, price_out=0.00030, arch="h2o-danube-3-4b"),
    PoolModel("qwen-14b", skill=0.85, verbosity=4.7, price_in=0.00080, price_out=0.00080, arch="internlm2-20b"),
    PoolModel("qwen-32b", skill=1.50, verbosity=4.8, price_in=0.00180, price_out=0.00180, arch="qwen2-72b"),
    PoolModel("llama-8b", skill=0.35, verbosity=5.0, price_in=0.00035, price_out=0.00035, arch="gemma3-4b"),
    PoolModel("r1-7b", skill=0.55, verbosity=6.0, price_in=0.00030, price_out=0.00030, arch="hymba-1.5b"),
    PoolModel("r1-14b", skill=1.05, verbosity=6.1, price_in=0.00080, price_out=0.00080, arch="xlstm-350m"),
]

_TOPIC_D = 8


@dataclasses.dataclass
class QAServe:
    """Arrays over N queries x M models."""

    queries: List[str]
    task: np.ndarray            # (N,) int — task family id
    difficulty: np.ndarray      # (N,) float latent (ground truth)
    input_len: np.ndarray       # (N,) int input token length
    correct: np.ndarray         # (N, M) {0,1}
    out_len: np.ndarray         # (N, M) int
    pool: List[PoolModel]
    topic: np.ndarray           # (N, _TOPIC_D)

    @property
    def n(self) -> int:
        return len(self.queries)

    @property
    def m(self) -> int:
        return len(self.pool)

    @property
    def price_in(self) -> np.ndarray:
        """(M,) $ per 1k input tokens (same field as RouteBatch.price_in)."""
        return np.array([p.price_in for p in self.pool])

    @property
    def price_out(self) -> np.ndarray:
        return np.array([p.price_out for p in self.pool])

    def cost_matrix(self) -> np.ndarray:
        """$ cost of each (query, model) pair with TRUE output lengths."""
        return (self.input_len[:, None] * self.price_in[None, :]
                + self.out_len * self.price_out[None, :]) / 1000.0

    def route_batch(self, loads, counts=None, *, with_truth: bool = True):
        """Produce the array-based routing request the Policy contract
        consumes (QAServe is one producer of RouteBatch, not the interface)."""
        from repro_torch.core.baselines import RouteBatch
        m = self.m
        return RouteBatch(
            queries=self.queries,
            input_len=np.asarray(self.input_len),
            price_in=self.price_in, price_out=self.price_out,
            loads=np.asarray(loads, float),
            counts=(np.zeros(m, float) if counts is None
                    else np.asarray(counts, float)),
            cost_true=self.cost_matrix() if with_truth else None,
            correct_true=self.correct.astype(float) if with_truth else None,
        )

    def split(self, train=0.7, val=0.2, seed=0):
        rng = np.random.RandomState(seed)
        idx = rng.permutation(self.n)
        n_tr = int(self.n * train)
        n_va = int(self.n * val)
        return (self.subset(idx[:n_tr]), self.subset(idx[n_tr:n_tr + n_va]),
                self.subset(idx[n_tr + n_va:]))

    def subset(self, idx) -> "QAServe":
        return QAServe(
            queries=[self.queries[i] for i in idx],
            task=self.task[idx], difficulty=self.difficulty[idx],
            input_len=self.input_len[idx], correct=self.correct[idx],
            out_len=self.out_len[idx], pool=self.pool, topic=self.topic[idx],
        )

    def restrict_models(self, model_idx) -> "QAServe":
        """Restrict to a sub-pool (columns) — e.g. Tables 5/6 fleets."""
        model_idx = list(model_idx)
        return QAServe(
            queries=self.queries, task=self.task, difficulty=self.difficulty,
            input_len=self.input_len, correct=self.correct[:, model_idx],
            out_len=self.out_len[:, model_idx],
            pool=[self.pool[j] for j in model_idx], topic=self.topic,
        )


_WORDBANK = {
    "mmlu": ("which enzyme gene protein oncogene receptor pathway catalyzes "
             "member following encoded answer choose option biology history "
             "law economics psychology philosophy anatomy").split(),
    "gpqa": ("graduate quantum spectroscopy hamiltonian orbital symmetry "
             "reaction stereochemistry relativistic decay cross section "
             "perturbation eigenstate degenerate").split(),
    "math500": ("prove integral polynomial roots converge series modulo prime "
                "triangle circle inscribed maximize derivative matrix "
                "determinant combinatorial").split(),
    "gsm8k": ("apples dollars minutes total each buys sells speed train "
              "remaining shares half twice children marbles costs per week "
              "how many left").split(),
}
_TASK_DIFF_MU = {"mmlu": 0.0, "gpqa": 1.6, "math500": 1.1, "gsm8k": -0.4}
_TASK_LEN_MU = {"mmlu": -0.4, "gpqa": 0.4, "math500": 0.5, "gsm8k": 0.1}


def generate(n: int = 2700, seed: int = 0,
             pool: Optional[List[PoolModel]] = None) -> QAServe:
    pool = pool or DEFAULT_POOL
    rng = np.random.RandomState(seed)
    m = len(pool)
    task_ids = rng.choice(len(TASKS), size=n, p=TASK_P)
    topic = rng.randn(n, _TOPIC_D) * 0.5
    affinity = np.random.RandomState(seed + 1).randn(m, _TOPIC_D) * 0.4

    difficulty = np.array([
        _TASK_DIFF_MU[TASKS[t]] + 0.9 * rng.randn() for t in task_ids])
    input_len = np.clip(rng.lognormal(4.3, 0.5, size=n), 16, 2048).astype(int)

    queries = []
    for i in range(n):
        words = _WORDBANK[TASKS[task_ids[i]]]
        k = int(np.clip(input_len[i] // 8, 4, 24))
        base = " ".join(rng.choice(words, size=k))
        # topic- and difficulty-indicative marker words: the latent routing
        # signal must be *observable in the text* for any predictor (trained
        # or retrieval) to have a learnable task, as in the real QAServe
        marks = [f"t{d}{'p' if topic[i, d] > 0 else 'n'}"
                 for d in range(_TOPIC_D) if abs(topic[i, d]) > 0.35]
        dlevel = int(np.clip((difficulty[i] + 2) * 2, 0, 7))
        queries.append(f"{base} {' '.join(marks)} d{dlevel} q{i}")

    skills = np.array([p.skill for p in pool])
    logits = 3.0 * (skills[None, :] - difficulty[:, None]) + topic @ affinity.T
    correct = (rng.rand(n, m) < 1.0 / (1.0 + np.exp(-logits))).astype(np.int8)

    mu = np.array([[p.verbosity + _TASK_LEN_MU[TASKS[t]] for p in pool]
                   for t in task_ids])
    out_len = np.clip(rng.lognormal(mu, 0.45), 8, L_MAX).astype(int)

    return QAServe(queries=queries, task=task_ids,
                   difficulty=difficulty, input_len=input_len,
                   correct=correct, out_len=out_len, pool=pool, topic=topic)


def bucketize(lengths: np.ndarray, n_buckets: int, l_max: int = L_MAX) -> np.ndarray:
    width = l_max / n_buckets
    return np.minimum((lengths / width).astype(int), n_buckets - 1)


def bucket_expectation(probs: np.ndarray, n_buckets: int,
                       l_max: int = L_MAX) -> np.ndarray:
    """Expected length under a bucket distribution (midpoint rule)."""
    width = l_max / n_buckets
    mids = (np.arange(n_buckets) + 0.5) * width
    return probs @ mids
