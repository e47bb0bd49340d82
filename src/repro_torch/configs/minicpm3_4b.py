"""minicpm3-4b — dense decoder with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B; hf] 62L d_model=2560 40H (kv=40: MLA)
d_ff=6400 vocab=73,448.  MLA ranks: q_lora 768, kv_lora 256,
qk_nope 64, qk_rope 32, v_head 64 — the decode cache stores the
compressed latent (256+32 per token instead of 2·40·96).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    d_head=96,
    mla=True,
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    rope_theta=1e4,
    norm_eps=1e-5,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        mla=True,
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        rope_theta=1e4,
    )
