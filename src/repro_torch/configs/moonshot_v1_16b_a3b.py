"""moonshot-v1-16b-a3b — Moonlight-16B-A3B (Kimi/Moonshot MoE).

[hf:moonshotai/Moonlight-16B-A3B; hf] 48L d_model=2048 16H (kv=16)
MoE 64 experts top-6, expert d_ff=1408, vocab 163,840.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=163840,
    n_experts=64,
    experts_per_token=6,
    rope_theta=50000.0,
    norm_eps=1e-5,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=48,
        moe_d_ff=48,
        vocab_size=512,
        n_experts=8,
        experts_per_token=2,
        rope_theta=50000.0,
    )
