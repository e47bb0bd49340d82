"""whisper-medium — encoder-decoder ASR backbone (conv frontend stubbed).

[arXiv:2212.04356; unverified] 24L enc + 24L dec, d_model=1024 16H
(kv=16) d_ff=4096 vocab=51,865; GELU MLPs, LayerNorm, learned absolute
positions, QKV bias.  The audio conv frontend is a STUB: inputs are
precomputed frame embeddings (B, 1500, d_model).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    act="gelu",
    qkv_bias=True,
    use_rope=False,
    learned_pos=True,
    encoder_frames=1500,
    max_position_embeddings=32768,
    norm_eps=1e-5,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="encdec",
        n_layers=2,
        encoder_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        act="gelu",
        qkv_bias=True,
        use_rope=False,
        learned_pos=True,
        encoder_frames=30,
        max_position_embeddings=128,
    )
