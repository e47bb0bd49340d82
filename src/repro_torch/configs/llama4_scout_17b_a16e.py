"""llama4-scout-17b-a16e — Llama-4 Scout (MoE, early fusion).

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] 48L d_model=5120 40H
(GQA kv=8) d_ff=8192 vocab=202,048, MoE 16 experts top-1.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    moe_d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    experts_per_token=1,
    rope_theta=500000.0,
    norm_eps=1e-5,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        moe_d_ff=96,
        vocab_size=512,
        n_experts=4,
        experts_per_token=1,
        rope_theta=500000.0,
    )
