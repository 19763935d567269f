"""dbrx-132b [moe] — 40L d6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
16 experts top-4 (fine-grained). [hf:databricks/dbrx-base; unverified]

~132B total (16 x 3*6144*10752 x 40 = 127B experts + attn + embed),
~36B active (top-4 of 16).
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        n_experts=16,
        top_k=4,
        moe_every=1,
        rope_theta=5e5,
        attn_policy="head_tp",
        active_params=36_000_000_000,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=512,
        n_experts=4,
        top_k=2,
        moe_every=1,
        attn_policy="head_tp",
        remat="none",
        logit_chunk=64,
    )
