"""Model registry: one uniform API over the architecture families.

``get_model(cfg)`` returns a :class:`ModelAPI` exposing

  * ``param_specs()``                  — PSpec tree (shapes, axes, init laws)
  * ``load(tree)``                     — the model holding a materialized tree
  * ``decode(params, cache, batch)``   — single-token serve step
  * ``prefill(params, tokens, s_max)`` — prompt pass filling the KV cache
  * ``cache_specs(batch, s_max)``      — decode-state PSpec tree
  * ``input_specs(shape)``             — ``(shape, dtype)`` record per input

The dense family is ported; the others raise ``NotImplementedError``
(``ROADMAP.md`` Queue 1 item 10), and so does ``loss`` (item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.models.layers import unported


@dataclasses.dataclass(frozen=True)
class InputSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype


def _no_loss(params, batch):
    raise unported("training", item=11)


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    param_specs: Callable[[], Any]
    load: Callable[[dict], torch.nn.Module]
    decode: Callable[[Any, Any, dict], tuple]
    cache_specs: Callable[[int, int], Any]
    prefill: Callable[..., tuple]
    loss: Callable[[Any, dict], tuple] = _no_loss

    # -- inputs -----------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> dict[str, InputSpec]:
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {
                "tokens": InputSpec((B, 1), torch.int32),
                "pos": InputSpec((B,), torch.int32),
            }
        return {
            "tokens": InputSpec((B, S), torch.int32),
            "labels": InputSpec((B, S), torch.int32),
        }

    def demo_batch(self, shape: ShapeConfig, seed: int = 0) -> dict[str, np.ndarray]:
        """Concrete random inputs matching input_specs (smoke tests)."""
        rng = np.random.default_rng(seed)
        out = {}
        for name, spec in self.input_specs(shape).items():
            if name == "pos":
                out[name] = np.zeros(spec.shape, np.int32)
            else:
                hi = max(self.cfg.vocab_size - 1, 2)
                out[name] = rng.integers(1, hi, size=spec.shape, dtype=np.int32)
        return out


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family != "dense":
        raise unported(f"the {cfg.family} family")
    transformer.check_dense(cfg)
    return ModelAPI(
        cfg=cfg,
        param_specs=lambda: transformer.param_specs(cfg),
        load=lambda tree: transformer.DecoderLM(cfg, tree),
        decode=lambda params, cache, batch: transformer.decode_step(cfg, params, cache, batch),
        cache_specs=lambda batch, s_max: transformer.cache_specs(cfg, batch, s_max),
        prefill=lambda params, tokens, s_max: transformer.prefill(cfg, params, tokens, s_max),
    )
