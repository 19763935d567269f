"""Model / run configuration dataclasses shared by every architecture.

A copy of ``repro.configs.base`` with ``dtype`` a ``torch.dtype``.  The
fields are the reference's, ``use_pallas`` included: the port keeps it for
config parity but dispatches its kernels by the tensors' device (CUDA:
the hand-written kernel; CPU: the plain version), never by this flag."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | encdec | xlstm | hymba
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0        # 0 -> full attention
    local_global_ratio: int = 0    # k -> pattern of k local layers then 1 global
    attn_policy: str = "head_tp"   # head_tp | seq_sp  (see DESIGN.md §4)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1             # MoE block every k-th layer (1 = all layers)
    dense_d_ff: int = 0            # FFN width of the non-MoE layers (moe_every>1)
    capacity_factor: float = 1.25

    # --- encoder-decoder ---
    n_enc_layers: int = 0

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    slstm_every: int = 0           # xLSTM: 1 sLSTM per group of this many layers

    # --- modality frontend (stubbed: input_specs provides embeddings) ---
    frontend: str = "none"         # none | audio | vision
    frontend_len: int = 0          # number of prefix embedding positions

    # --- numerics / compilation ---
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-5
    remat: str = "full"            # none | full | dots
    scan_layers: bool = True
    tie_embeddings: bool = False
    logit_chunk: int = 2048        # chunked-vocab CE: tokens per logit chunk
    use_pallas: bool = False       # reference's TPU switch; unused here

    # hillclimb (EXPERIMENTS.md §Perf iter 5): int8 KV cache with per
    # (token, kv-head) scales — halves decode cache reads (decode is
    # memory-bound on cache + params)
    kv_cache_dtype: str = "bf16"   # bf16 | int8

    # bookkeeping for routing cost model (active params for MoE pricing)
    active_params: int = 0

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_is_moe(self, layer_idx: int) -> bool:
        if self.n_experts == 0:
            return False
        return (layer_idx % self.moe_every) == (self.moe_every - 1)

    def layer_is_global_attn(self, layer_idx: int) -> bool:
        """For local:global interleaving (gemma3-style k:1)."""
        if self.local_global_ratio <= 0:
            return self.sliding_window == 0
        return (layer_idx % (self.local_global_ratio + 1)) == self.local_global_ratio


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / memory policy for train_step."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1
    moment_dtype: str = "int8"     # int8 | bf16 | fp32  (quantized Adam states)
    master_dtype: Optional[str] = None   # None -> update bf16 params directly
    accum_dtype: str = "bf16"      # gradient accumulation buffer dtype
    grad_compression: str = "none" # none | int8  (compressed cross-pod all-reduce)
    zero_moments: bool = True      # shard moments over ('data','model') (ZeRO-1)
    # hillclimb (EXPERIMENTS.md §Perf iter 3): gather FSDP-sharded weights once
    # per step instead of once per microbatch — trades peak memory for a /G
    # reduction in all-gather bytes. Enabled where the gathered set fits HBM.
    hoist_gather: bool = False
