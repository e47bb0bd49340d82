"""yi-6b — LLaMA-architecture dense decoder with aggressive GQA.

[arXiv:2403.04652; hf] 32L d_model=4096 32H (GQA kv=4) d_ff=11008
vocab=64,000.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5e6,
    norm_eps=1e-5,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        rope_theta=5e6,
    )
