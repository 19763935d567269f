"""gemma3-4b [dense] — 34L d2560 8H (GQA kv=4) head_dim=256 d_ff=10240
vocab=262144, 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

8 heads % 16 != 0 -> sequence-parallel attention policy.
long_500k applicable: 5/6 of layers are 1024-window SWA; the 1/6 global layers
use the ('data','model')-sharded KV cache (DESIGN.md §6).
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        sliding_window=1024,
        local_global_ratio=5,
        rope_theta=1e6,
        attn_policy="seq_sp",
        tie_embeddings=True,
        active_params=4_000_000_000,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke",
        family="dense",
        n_layers=6,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        sliding_window=16,
        local_global_ratio=5,
        attn_policy="seq_sp",
        tie_embeddings=True,
        remat="none",
        logit_chunk=64,
    )
