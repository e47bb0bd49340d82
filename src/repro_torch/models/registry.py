"""Model registry: one uniform API over the architecture families.

``get_model(cfg)`` returns a :class:`ModelAPI` exposing

  * ``param_specs()``                  — PSpec tree (shapes, axes, init laws)
  * ``load(tree, trainable=False)``    — the model holding a materialized tree
    (``trainable``: f32 master parameters that require gradients)
  * ``loss(params, batch)``            — train objective: (loss, {"xent", "aux"})
  * ``decode(params, cache, batch)``   — single-token serve step
  * ``prefill(params, tokens, s_max)`` — prompt pass filling the KV cache,
    ``None`` for a family with no prefill (the hybrid, the encoder-decoder)
  * ``cache_specs(batch, s_max)``      — decode-state PSpec tree
  * ``input_specs(shape)``             — ``(shape, dtype)`` record per input

Every family is ported: dense (MLA included), MoE, VLM, SSM, hybrid and
encoder-decoder; ``input_pspecs(shape)`` gives each input's logical
mesh axes as a spec tuple.  The modality frontends are stubs, as in the
reference:
the VLM's training inputs carry precomputed patch embeddings, the
encoder-decoder's precomputed audio frame embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, ssm_lm, transformer


@dataclasses.dataclass(frozen=True)
class InputSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    param_specs: Callable[[], Any]
    load: Callable[..., torch.nn.Module]
    loss: Callable[[Any, dict], tuple]
    decode: Callable[[Any, Any, dict], tuple]
    cache_specs: Callable[[int, int], Any]
    prefill: Callable[..., tuple] | None

    # -- inputs -----------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> dict[str, InputSpec]:
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.kind == "decode":
            return {"tokens": InputSpec((B, 1), i32), "pos": InputSpec((B,), i32)}
        specs = {"tokens": InputSpec((B, S), i32), "labels": InputSpec((B, S), i32)}
        if cfg.family == "vlm":
            specs["vision_embeds"] = InputSpec(
                (B, cfg.vision_patches, cfg.vision_dim), torch.bfloat16)
            specs["vision_pos"] = InputSpec((B, cfg.vision_patches), i32)
            specs["positions"] = InputSpec((3, B, S), i32)
        if cfg.family == "encdec":
            specs["frames"] = InputSpec((B, cfg.encoder_frames, cfg.d_model), torch.bfloat16)
        return specs

    def input_pspecs(self, shape: ShapeConfig) -> dict[str, tuple]:
        """Each input's logical spec tuple: the batch over ``data`` (dim 1 of
        the VLM's (3, B, S) ``positions``), audio frames' width over ``model``."""
        if shape.kind == "decode":
            return {"tokens": ("data", None), "pos": ("data",)}
        specs = {"tokens": ("data", None), "labels": ("data", None)}
        if self.cfg.family == "vlm":
            specs["vision_embeds"] = ("data", None, None)
            specs["vision_pos"] = ("data", None)
            specs["positions"] = (None, "data", None)
        if self.cfg.family == "encdec":
            specs["frames"] = ("data", None, "model")
        return specs

    def demo_batch(self, shape: ShapeConfig, seed: int = 0) -> dict[str, np.ndarray]:
        """Concrete random inputs matching input_specs (smoke tests), drawn
        in the reference's order from the same numpy generator."""
        rng = np.random.default_rng(seed)
        out = {}
        for name, spec in self.input_specs(shape).items():
            if spec.dtype != torch.int32:
                out[name] = rng.normal(0, 0.3, size=spec.shape).astype(np.float32)
            elif name == "pos":
                out[name] = np.zeros(spec.shape, np.int32)
            elif name in ("positions", "vision_pos"):
                out[name] = np.broadcast_to(
                    np.arange(spec.shape[-1], dtype=np.int32), spec.shape).copy()
            else:
                hi = max(self.cfg.vocab_size - 1, 2)
                out[name] = rng.integers(1, hi, size=spec.shape, dtype=np.int32)
        return out


def get_model(cfg: ModelConfig) -> ModelAPI:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        mod = transformer
    elif fam == "ssm":
        mod = ssm_lm
    elif fam == "hybrid":
        mod = hybrid
    elif fam == "encdec":
        mod = encdec
    else:
        raise ValueError(f"unknown family {fam!r}")
    return ModelAPI(
        cfg=cfg,
        param_specs=lambda: mod.param_specs(cfg),
        load=lambda tree, trainable=False: mod.load(cfg, tree, trainable),
        loss=lambda params, batch: mod.loss_fn(cfg, params, batch),
        decode=lambda params, cache, batch: mod.decode_step(cfg, params, cache, batch),
        cache_specs=lambda batch, s_max: mod.cache_specs(cfg, batch, s_max),
        prefill=(
            (lambda params, tokens, s_max: mod.prefill(cfg, params, tokens, s_max))
            if hasattr(mod, "prefill")
            else None
        ),
    )
