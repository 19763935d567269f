"""seamless-m4t-large-v2 [audio] — enc-dec, 24L encoder + 24L decoder,
d1024 16H (kv=16) d_ff=8192 vocab=256206. [arXiv:2308.11596; hf]

The speech frontend (fbank -> conformer adaptor) is a STUB: input_specs()
provides precomputed frame embeddings (B, S, d) directly to the encoder.
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="encdec",
        n_layers=24,          # decoder layers
        n_enc_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        frontend="audio",
        rope_theta=1e4,
        attn_policy="head_tp",
        active_params=2_300_000_000,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        frontend="audio",
        attn_policy="head_tp",
        remat="none",
        logit_chunk=64,
    )
