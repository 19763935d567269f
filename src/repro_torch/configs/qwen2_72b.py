"""qwen2-72b [dense] — 80L d8192 64H (GQA kv=8) d_ff=29568 vocab=152064,
QKV bias. [arXiv:2407.10671; hf]
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
        attn_policy="head_tp",
        active_params=72_000_000_000,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        qkv_bias=True,
        attn_policy="head_tp",
        remat="none",
        logit_chunk=64,
    )
