"""hymba-1.5b [hybrid] — 32L d1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16; parallel attention + mamba heads in every layer.
[arXiv:2411.13676; hf]

TPU adaptation: the mamba branch runs in SSD (chunked scalar-decay) form —
matmul-dominant for the MXU. Attention is SWA with periodic global layers
(~3 of 32), per the paper. 25 heads % 16 != 0 -> sequence-parallel attention.
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hymba",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        sliding_window=1024,
        local_global_ratio=10,
        rope_theta=1e4,
        attn_policy="seq_sp",
        active_params=1_500_000_000,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke",
        family="hymba",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        ssm_state=8,
        sliding_window=16,
        local_global_ratio=10,
        attn_policy="seq_sp",
        remat="none",
        logit_chunk=64,
    )
