"""xlstm-350m [ssm] — 24L d1024 4H vocab=50304, sLSTM + mLSTM blocks
(1 sLSTM per 6-layer group, rest mLSTM). [arXiv:2405.04517; unverified]

TPU adaptation (DESIGN.md §3): mLSTM runs in chunked linear-attention form
(matmul-dominant, MXU-aligned); the normalizer rides as an extra value column.
sLSTM keeps its sequential scan (non-associative exponential gating) — its
recurrent matmuls are head-block-diagonal, per the paper.

d_ff=0: xLSTM blocks have no separate FFN (projection factor 2 inside block).
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="xlstm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        slstm_every=6,
        ssm_state=256,          # qk dim per head (state rows)
        attn_policy="seq_sp",   # heads replicated; value-dim TP inside block
        tie_embeddings=True,
        active_params=400_000_000,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke",
        family="xlstm",
        n_layers=6,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab_size=512,
        slstm_every=6,
        ssm_state=16,
        attn_policy="seq_sp",
        tie_embeddings=True,
        remat="none",
        logit_chunk=64,
    )
