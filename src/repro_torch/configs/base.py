"""Architecture + shape configuration schema.

One module per assigned architecture lives next to this file; each
exports ``CONFIG`` (the exact literature configuration) and
``smoke_config()`` (a reduced same-family variant for CPU tests).

Shapes are the assignment's four input-shape cells; ``decode_*`` /
``long_*`` lower ``serve_step`` (single-token decode against a KV cache
of ``seq_len``), the others lower ``train_step``.
"""

from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'encdec' | 'vlm'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    act: str = "silu"  # 'silu' (gated) | 'gelu'
    norm_eps: float = 1e-5
    qkv_bias: bool = False
    rope_theta: float = 1e6
    use_rope: bool = True  # False: learned absolute positions (Whisper)
    tie_embeddings: bool = False
    max_position_embeddings: int = 32768

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # expert hidden size (0 -> d_ff)
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    router_aux_weight: float = 0.01

    # MLA (multi-head latent attention, MiniCPM3/DeepSeek style)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # M-RoPE (Qwen2-VL)
    mrope: bool = False
    mrope_sections: tuple[int, int, int] = (16, 24, 24)

    # SSM (Mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    # Hybrid (Jamba): period structure
    period: int = 0  # layers per period (0 = homogeneous stack)
    attn_layer_offset: int = 4  # index of the attention layer in a period
    attn_layer_period: int = 8
    expert_layer_offset: int = 1  # MoE FFN on odd layers (period 2)
    expert_layer_period: int = 2

    # Encoder-decoder (Whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500  # post-conv source positions (stubbed frontend)
    learned_pos: bool = False

    # VLM (vision frontend stub)
    vision_patches: int = 0  # patches provided by input_specs
    vision_dim: int = 0  # incoming patch-embedding dim (stub projector input)

    # Activation-checkpoint policy: layers per remat group (two-level
    # scan: only group-boundary activations are saved; groups recompute
    # in backward). 0 = one group per layer (save every layer input).
    remat_group: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper via its decoder)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "train"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "moonshot_v1_16b_a3b",
    "llama4_scout_17b_a16e",
    "qwen2_vl_7b",
    "falcon_mamba_7b",
    "jamba_v0_1_52b",
    "whisper_medium",
    "yi_6b",
    "qwen2_72b",
    "minicpm3_4b",
    "qwen1_5_0_5b",
]


def _module(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a (arch, shape) cell runs, and why not if it doesn't.

    `long_500k` needs sub-quadratic sequence mixing — run for SSM/hybrid,
    skip for pure full-attention archs (noted in DESIGN.md §5).
    """
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "full-attention arch: 500k dense decode out of scope"
    return True, ""
