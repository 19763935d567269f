"""h2o-danube-3-4b [dense] — 24L d3840 32H (GQA kv=8) d_ff=10240 vocab=32000,
llama+mistral mix with sliding-window attention. [arXiv:2401.16818; unverified]
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        sliding_window=4096,
        rope_theta=1e4,
        attn_policy="head_tp",
        active_params=4_000_000_000,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        sliding_window=16,
        attn_policy="head_tp",
        remat="none",
        logit_chunk=64,
    )
