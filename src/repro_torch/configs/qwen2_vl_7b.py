"""qwen2-vl-7b — Qwen2-VL-7B backbone (M-RoPE, dynamic resolution).

[arXiv:2409.12191; hf] 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152,064.  The vision tower is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings (ViT hidden
size 1280) merged into the token stream at given positions; positions
are 3-stream M-RoPE ids (temporal/height/width, sections 16/24/24).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    mrope=True,
    mrope_sections=(16, 24, 24),
    vision_patches=1024,
    vision_dim=1280,
    norm_eps=1e-6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        mrope=True,
        mrope_sections=(2, 3, 3),
        vision_patches=8,
        vision_dim=48,
    )
