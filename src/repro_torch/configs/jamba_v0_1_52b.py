"""jamba-v0.1-52b — hybrid Mamba/attention 7:1 + MoE.

[arXiv:2403.19887; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65,536, MoE 16e top-2.  Attention every 8th layer (offset 4),
MoE FFN every 2nd layer (offset 1); Jamba uses no positional encoding
(the Mamba mixers carry position).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    moe_d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    use_rope=False,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    attn_layer_period=8,
    attn_layer_offset=4,
    expert_layer_period=2,
    expert_layer_offset=1,
    norm_eps=1e-6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        moe_d_ff=96,
        vocab_size=512,
        n_experts=4,
        experts_per_token=2,
        use_rope=False,
        ssm_state=8,
        attn_layer_period=4,
        attn_layer_offset=2,
        expert_layer_period=2,
        expert_layer_offset=1,
    )
