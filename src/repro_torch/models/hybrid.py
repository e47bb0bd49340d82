"""Jamba-style hybrid: Mamba/attention 7:1 interleave, MoE every 2nd FFN.

The stack is heterogeneous, so it is built from *periods*: Jamba's layer
pattern has period 8 (attention at offset 4, the rest Mamba; MoE FFN on
odd layers), and a 32-layer model is 4 periods of 8 sublayers.  The
parameter tree stacks the periods, as the reference's does (its
``lax.scan`` over periods is a Python loop here), so a depth is cut only
in whole periods.

Decode carries a heterogeneous cache: each period holds 7 SSM states and
one KV cache, updated in place.  As in the reference there is no
``prefill``: a prompt is fed as decode steps from a zero cache.  Each
attention sublayer of ``forward_train`` runs the ``flash_attn`` kernel;
Jamba uses no positional encoding.  With grad mode on, ``forward_train``
checkpoints each period (one period is already remat-group sized), as
the reference's ``stacked_scan`` over periods does.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moelib
from repro_torch.models import ssm
from repro_torch.models.layers import (
    attention_cache_specs,
    attention_decode,
    attention_specs,
    attention_train,
    embed_lookup,
    embed_spec,
    mlp,
    mlp_specs,
    rmsnorm,
    rmsnorm_spec,
    softmax_xent,
    shard_batch,
    unembed,
)
from repro_torch.models.param import Params, f32_param, layer_group, stack
from repro_torch.models.scan_utils import stacked_scan


def _period(cfg: ModelConfig) -> int:
    return cfg.period or cfg.attn_layer_period


def _is_attn(cfg: ModelConfig, i: int) -> bool:
    return i % cfg.attn_layer_period == cfg.attn_layer_offset


def _is_moe(cfg: ModelConfig, i: int) -> bool:
    return cfg.n_experts > 0 and i % cfg.expert_layer_period == cfg.expert_layer_offset


def _n_periods(cfg: ModelConfig) -> int:
    per = _period(cfg)
    assert cfg.n_layers % per == 0
    return cfg.n_layers // per


def period_specs(cfg: ModelConfig) -> dict:
    """Specs for one period (its heterogeneous sublayers)."""
    layers = {}
    for i in range(_period(cfg)):
        layers[f"l{i}"] = {
            "ln1": rmsnorm_spec(cfg.d_model),
            "ln2": rmsnorm_spec(cfg.d_model),
            "mixer": attention_specs(cfg) if _is_attn(cfg, i) else ssm.ssm_specs(cfg),
            "ffn": moelib.moe_specs(cfg) if _is_moe(cfg, i) else mlp_specs(cfg),
        }
    return layers


def param_specs(cfg: ModelConfig) -> dict:
    return {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        "periods": stack(_n_periods(cfg), period_specs(cfg)),
        "ln_f": rmsnorm_spec(cfg.d_model),
        "lm_head": embed_spec(cfg.vocab_size, cfg.d_model),
    }


class HybridLM(Params):
    """The hybrid's parameters from a reference-shaped tree (``embed``,
    ``periods`` stacked on their first axis, ``ln_f``, ``lm_head``):
    ``periods.<p>.l<i>.{ln1, mixer, ln2, ffn}``.  Norm scales, the
    embedding, the LM head and ``param.F32_LEAVES`` stay f32
    (``trainable``: every leaf an f32 master)."""

    def __init__(self, cfg: ModelConfig, tree: dict, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed = f32_param(tree["embed"], trainable)
        stacked = tree["periods"]
        periods = []
        for p in range(_n_periods(cfg)):
            period = Params()
            for i in range(_period(cfg)):
                src, layer = stacked[f"l{i}"], Params()
                layer.ln1 = f32_param(src["ln1"][p], trainable)
                layer.mixer = layer_group(src["mixer"], p, trainable)
                layer.ln2 = f32_param(src["ln2"][p], trainable)
                layer.ffn = layer_group(src["ffn"], p, trainable)
                setattr(period, f"l{i}", layer)
            periods.append(period)
        self.periods = nn.ModuleList(periods)
        self.ln_f = f32_param(tree["ln_f"], trainable)
        self.lm_head = f32_param(tree["lm_head"], trainable)


def load(cfg: ModelConfig, tree: dict, trainable: bool = False) -> HybridLM:
    return HybridLM(cfg, tree, trainable)


def _ffn(cfg: ModelConfig, i: int, p, h):
    if _is_moe(cfg, i):
        return moelib.moe_ffn(cfg, p, h)
    return mlp(cfg, p, h), torch.zeros((), device=h.device)


def _period_train(cfg: ModelConfig, p, x, positions):
    aux_total = torch.zeros((), device=x.device)
    x = shard_batch(x)
    for i in range(_period(cfg)):
        lp = p[f"l{i}"]
        x = shard_batch(x)
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if _is_attn(cfg, i):
            x = x + attention_train(cfg, lp["mixer"], h, positions)
        else:
            x = x + ssm.ssm_forward(cfg, lp["mixer"], h)
        f, aux = _ffn(cfg, i, lp["ffn"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
        x = x + f
        aux_total = aux_total + aux
    return x, aux_total


def forward_train(cfg: ModelConfig, params, tokens):
    """Hidden states (B, S, D) of a full sequence and the router's
    load-balance loss summed over the MoE sublayers."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = shard_batch(embed_lookup(params["embed"], tokens))
    body = functools.partial(_period_train, cfg)
    x, aux = stacked_scan(body, x, params["periods"], 0, positions)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux


def loss_fn(cfg: ModelConfig, params, batch):
    hidden, aux = forward_train(cfg, params, batch["tokens"])
    loss = softmax_xent(logits_of(cfg, params, hidden), batch["labels"])
    return loss + cfg.router_aux_weight * aux, {"xent": loss, "aux": aux}


def logits_of(cfg: ModelConfig, params, hidden):
    return shard_batch(unembed(params["lm_head"], hidden), model_dim=-1)


def cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    entry = {}
    for i in range(_period(cfg)):
        if _is_attn(cfg, i):
            entry[f"l{i}"] = attention_cache_specs(cfg, batch, s_max)
        else:
            entry[f"l{i}"] = ssm.ssm_cache_specs(cfg, batch)
    return {"periods": stack(_n_periods(cfg), entry)}


def decode_step(cfg: ModelConfig, params, cache, batch):
    """One-token decode. batch: tokens (B,1), pos (B,). Returns (logits
    (B,1,V), cache); every period's KV cache and SSM state are updated in
    place (views of the stacked cache tensors)."""
    tokens, pos = batch["tokens"], batch["pos"]
    x = embed_lookup(params["embed"], tokens)
    stacked = cache["periods"]
    for n, p in enumerate(params["periods"]):
        for i in range(_period(cfg)):
            lp = p[f"l{i}"]
            lc = {name: t[n] for name, t in stacked[f"l{i}"].items()}
            h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
            if _is_attn(cfg, i):
                out, _ = attention_decode(cfg, lp["mixer"], h, lc, pos)
            else:
                out, _ = ssm.ssm_decode(cfg, lp["mixer"], h, lc)
            x = x + out
            f, _ = _ffn(cfg, i, lp["ffn"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
            x = x + f
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits_of(cfg, params, x), cache
