"""qwen2-72b — large dense decoder, GQA + QKV bias.

[arXiv:2407.10671; hf] 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152,064.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
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
    norm_eps=1e-6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        qkv_bias=True,
        rope_theta=1e6,
    )
