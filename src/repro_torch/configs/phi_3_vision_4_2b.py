"""phi-3-vision-4.2b [vlm] — 32L d3072 32H (kv=32) d_ff=8192 vocab=32064,
phi3-mini backbone + CLIP frontend. [hf:microsoft/Phi-3-vision-128k-instruct; hf]

The CLIP image frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, 576, d) prepended to the token sequence.
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        frontend="vision",
        frontend_len=576,
        rope_theta=1e4,
        attn_policy="head_tp",
        active_params=4_200_000_000,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3v-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        frontend="vision",
        frontend_len=16,
        attn_policy="head_tp",
        remat="none",
        logit_chunk=64,
    )
