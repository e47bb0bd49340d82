"""Pure-SSM language model (the Falcon-Mamba-7B family).

Stack: embed -> n_layers x (RMSNorm -> Mamba block -> residual) ->
RMSNorm -> unembed.  The decode state is O(1) a token (conv window and
SSM state, :mod:`repro_torch.models.ssm`).  As in the reference,
``prefill`` runs the prompt as decode steps, one token at a time; only
the last step's logits are computed, the only ones it returns.  No layer
attends, so no path here launches ``flash_attn``.  Training
(:func:`loss_fn`) checkpoints the layer loop in groups of
``cfg.remat_group`` (:mod:`repro_torch.models.scan_utils`).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm
from repro_torch.models.layers import (
    embed_lookup, embed_spec, rmsnorm, rmsnorm_spec, shard_batch, softmax_xent, unembed,
)
from repro_torch.models.param import Params, f32_param, layer_group, spec_tree_map, stack
from repro_torch.models.scan_utils import stacked_scan


def layer_specs(cfg: ModelConfig) -> dict:
    return {"ln": rmsnorm_spec(cfg.d_model), "mixer": ssm.ssm_specs(cfg)}


def param_specs(cfg: ModelConfig) -> dict:
    specs = {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        "layers": stack(cfg.n_layers, layer_specs(cfg)),
        "ln_f": rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = embed_spec(cfg.vocab_size, cfg.d_model)
    return specs


class MambaLM(Params):
    """The SSM LM's parameters from a reference-shaped tree: norms, the
    embedding, the LM head, ``A_log`` and ``D`` in f32, the rest bf16
    (``trainable``: every leaf an f32 master)."""

    def __init__(self, cfg: ModelConfig, tree: dict, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed = f32_param(tree["embed"], trainable)
        stacked = tree["layers"]
        layers = []
        for i in range(cfg.n_layers):
            layer = Params()
            layer.ln = f32_param(stacked["ln"][i], trainable)
            layer.mixer = layer_group(stacked["mixer"], i, trainable)
            layers.append(layer)
        self.layers = nn.ModuleList(layers)
        self.ln_f = f32_param(tree["ln_f"], trainable)
        if not cfg.tie_embeddings:
            self.lm_head = f32_param(tree["lm_head"], trainable)


def load(cfg: ModelConfig, tree: dict, trainable: bool = False) -> MambaLM:
    return MambaLM(cfg, tree, trainable)


def _layer_train(cfg: ModelConfig, p, x):
    x = shard_batch(x)
    out = x + ssm.ssm_forward(cfg, p["mixer"], rmsnorm(p["ln"], x, cfg.norm_eps))
    return out, torch.zeros((), device=x.device)


def forward_train(cfg: ModelConfig, params, tokens):
    """Hidden states (B, S, D) of a full sequence (the chunked scan)."""
    x = shard_batch(embed_lookup(params["embed"], tokens))
    x, _ = stacked_scan(functools.partial(_layer_train, cfg), x, params["layers"],
                        cfg.remat_group)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps)


def logits_of(cfg: ModelConfig, params, hidden):
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return shard_batch(unembed(table, hidden), model_dim=-1)


def loss_fn(cfg: ModelConfig, params, batch):
    hidden = forward_train(cfg, params, batch["tokens"])
    loss = softmax_xent(logits_of(cfg, params, hidden), batch["labels"])
    return loss, {"xent": loss, "aux": torch.zeros((), device=loss.device)}


def cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    # the SSM state does not depend on s_max: O(1) decode memory
    return {"layers": stack(cfg.n_layers, ssm.ssm_cache_specs(cfg, batch))}


def _step(cfg: ModelConfig, params, cache, tokens):
    """One token (B, 1) through the stack, the cache updated in place;
    returns the residual stream before the final norm."""
    x = embed_lookup(params["embed"], tokens)
    convs, hs = cache["layers"]["conv"], cache["layers"]["h"]
    for i, lp in enumerate(params["layers"]):
        out, _ = ssm.ssm_decode(cfg, lp["mixer"], rmsnorm(lp["ln"], x, cfg.norm_eps),
                                {"conv": convs[i], "h": hs[i]})
        x = x + out
    return x


def decode_step(cfg: ModelConfig, params, cache, batch):
    """One-token decode. batch: tokens (B,1) (``pos`` is not read).
    Returns (logits (B,1,V), cache); the cache is updated in place."""
    x = _step(cfg, params, cache, batch["tokens"])
    return logits_of(cfg, params, rmsnorm(params["ln_f"], x, cfg.norm_eps)), cache


def prefill(cfg: ModelConfig, params, tokens, s_max: int):
    """The prompt as S decode steps. Returns (last-step logits (B,1,V), cache)."""
    B, S = tokens.shape
    cache = spec_tree_map(
        lambda ps: torch.zeros(ps.shape, dtype=ps.dtype, device=tokens.device),
        cache_specs(cfg, B, s_max),
    )
    for t in range(S):
        x = _step(cfg, params, cache, tokens[:, t:t + 1])
    return logits_of(cfg, params, rmsnorm(params["ln_f"], x, cfg.norm_eps)), cache
