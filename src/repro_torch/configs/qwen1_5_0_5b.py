"""qwen1.5-0.5b — small dense decoder, QKV bias, tied embeddings.

[hf:Qwen/Qwen1.5-0.5B; hf] 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151,936.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e4,
    norm_eps=1e-6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1e4,
    )
