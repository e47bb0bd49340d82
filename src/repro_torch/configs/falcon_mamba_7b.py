"""falcon-mamba-7b — attention-free Mamba-1 LM.

[arXiv:2410.05355; unverified] 64L d_model=4096 (attn-free) vocab=65,024,
ssm_state=16, expand 2 (d_inner 8192), conv 4, dt_rank 256.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    norm_eps=1e-5,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=512,
        ssm_state=8,
        ssm_conv=4,
        ssm_expand=2,
    )
