"""Decoder-only transformer, dense family: forward, prefill, decode.

The model is a :class:`DecoderLM` module whose submodule and parameter
names follow the reference's parameter tree (``embed``,
``layers.<i>.ln1``, ``layers.<i>.attn.wq``, ..., ``ln_f``,
``lm_head``), so a state-dict key names its JAX leaf with the layer
index split out of the stacked axis.  The reference's ``lax.scan`` over
stacked layers is a Python loop here.  One module serves the dense
configurations (Yi, Qwen2, Qwen1.5); the MoE, MLA and VLM variants of
the reference's module raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    _apply_rope,
    _attend,
    _qkv,
    attention_cache_specs,
    attention_decode,
    attention_specs,
    attention_train,
    embed_lookup,
    embed_spec,
    mlp,
    mlp_specs,
    mp,
    rmsnorm,
    rmsnorm_spec,
    unembed,
    unported,
)
from repro_torch.models.param import spec_tree_map, stack


def check_dense(cfg: ModelConfig) -> None:
    """Raise for the variants of the reference's module that wait for later slices."""
    if cfg.n_experts:
        raise unported("the MoE family")
    if cfg.mla:
        raise unported("MLA attention")
    if cfg.vision_dim or cfg.mrope:
        raise unported("the VLM family")


def layer_specs(cfg: ModelConfig) -> dict:
    check_dense(cfg)
    d = cfg.d_model
    return {
        "ln1": rmsnorm_spec(d),
        "attn": attention_specs(cfg),
        "ln2": rmsnorm_spec(d),
        "ffn": mlp_specs(cfg),
    }


def param_specs(cfg: ModelConfig) -> dict:
    specs = {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        "layers": stack(cfg.n_layers, layer_specs(cfg)),
        "ln_f": rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = embed_spec(cfg.vocab_size, cfg.d_model)
    return specs


class Params(nn.Module):
    """A module whose parameters and submodules also read as ``p[name]``,
    the way the layer functions read the reference's parameter dicts."""

    def __getitem__(self, name: str):
        return getattr(self, name)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _group(stacked: dict, i: int) -> Params:
    # Projections and biases go to bf16 once, here; the reference keeps f32
    # masters and casts them with mp() at every use, which gives the same numbers.
    g = Params()
    for name in sorted(stacked):
        g.register_parameter(name, _param(mp(stacked[name][i])))
    return g


class DecoderLM(Params):
    """The dense decoder's parameters, loaded from a reference-shaped tree
    (stacked layer axis first).  Norm scales, the embedding and the LM
    head stay f32: ``rmsnorm`` and ``unembed`` read them in f32."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        check_dense(cfg)
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tree["embed"].float())
        stacked = tree["layers"]
        layers = []
        for i in range(cfg.n_layers):
            layer = Params()
            layer.ln1 = _param(stacked["ln1"][i].float())
            layer.attn = _group(stacked["attn"], i)
            layer.ln2 = _param(stacked["ln2"][i].float())
            layer.ffn = _group(stacked["ffn"], i)
            layers.append(layer)
        self.layers = nn.ModuleList(layers)
        self.ln_f = _param(tree["ln_f"].float())
        if not cfg.tie_embeddings:
            self.lm_head = _param(tree["lm_head"].float())


def _layer_train(cfg: ModelConfig, p, x, positions):
    x = x + attention_train(cfg, p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), positions)
    return x + mlp(cfg, p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))


def forward_train(cfg: ModelConfig, params, tokens, positions):
    """Hidden states for a full sequence. Returns (hidden (B,S,D), aux); the
    router's auxiliary loss is 0 in the dense family."""
    x = embed_lookup(params["embed"], tokens)
    for lp in params["layers"]:
        x = _layer_train(cfg, lp, x, positions)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), torch.zeros((), device=x.device)


def logits_of(cfg: ModelConfig, params, hidden):
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(table, hidden)


def make_positions(cfg: ModelConfig, tokens):
    if cfg.mrope:
        raise unported("M-RoPE (the VLM family)")
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)


# ---------------------------------------------------------------------------
# Decode (serve_step) — KV cache over the layers
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    check_dense(cfg)
    return {"layers": stack(cfg.n_layers, attention_cache_specs(cfg, batch, s_max))}


def _empty_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> dict:
    return spec_tree_map(
        lambda ps: torch.zeros(ps.shape, dtype=ps.dtype, device=device),
        cache_specs(cfg, batch, s_max),
    )


def _layer_decode(cfg: ModelConfig, p, cache, x, pos):
    a, cache = attention_decode(cfg, p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), cache, pos)
    x = x + a
    return x + mlp(cfg, p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps)), cache


def decode_step(cfg: ModelConfig, params, cache, batch):
    """One-token decode. batch: tokens (B,1), pos (B,). Returns
    (logits (B,1,V), cache); the cache is updated in place."""
    tokens, pos = batch["tokens"], batch["pos"]
    x = embed_lookup(params["embed"], tokens)
    ks, vs = cache["layers"]["k"], cache["layers"]["v"]
    for i, lp in enumerate(params["layers"]):
        x, _ = _layer_decode(cfg, lp, {"k": ks[i], "v": vs[i]}, x, pos)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits_of(cfg, params, x), cache


def prefill(cfg: ModelConfig, params, tokens, s_max: int):
    """Run the prompt through the stack, returning (last-position logits
    (B,1,V), cache).

    Each layer's rotated K and V go into the cache; its attention runs
    the flash kernel once, over the q/k/v it computed for the cache.
    """
    B, S = tokens.shape
    positions = make_positions(cfg, tokens)
    x = embed_lookup(params["embed"], tokens)
    cache = _empty_cache(cfg, B, s_max, x.device)
    ks, vs = cache["layers"]["k"], cache["layers"]["v"]
    for i, lp in enumerate(params["layers"]):
        normed = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = _qkv(cfg, lp["attn"], normed)
        q, k = _apply_rope(cfg, q, k, positions)
        ks[i, :, :, :S] = k.transpose(1, 2)
        vs[i, :, :, :S] = v.transpose(1, 2)
        x = x + _attend(cfg, lp["attn"], q, k, v, x.dtype)
        x = x + mlp(cfg, lp["ffn"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits_of(cfg, params, x[:, -1:, :]), cache
