"""llama4-maverick-400b-a17b [moe] — 48L d5120 40H (GQA kv=8) expert_ff=8192
vocab=202048, MoE 128 experts top-1 + 1 shared, MoE every 2nd layer.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Derivation: routed experts 24 MoE layers x 128 x 3*5120*8192 = 386B; dense layers
(d_ff 16384) 6.0B; attention 3.0B; embeddings 2.1B -> ~400B total, ~17B active
(attn + dense + shared + 1 routed expert per MoE layer).

40 heads % 16 != 0 -> sequence-parallel attention policy (DESIGN.md §4).
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,               # per-expert FFN width
        dense_d_ff=16384,        # width of the interleaved dense layers
        vocab_size=202048,
        n_experts=128,
        top_k=1,
        n_shared_experts=1,
        moe_every=2,
        rope_theta=5e5,
        attn_policy="seq_sp",
        active_params=17_000_000_000,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke",
        family="moe",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        dense_d_ff=256,
        vocab_size=512,
        n_experts=8,
        top_k=1,
        n_shared_experts=1,
        moe_every=2,
        attn_policy="seq_sp",
        remat="none",
        logit_chunk=64,
    )
