"""Decoder-only transformer (dense / MoE / MLA / VLM): forward, prefill, decode.

The model is a :class:`DecoderLM` module whose submodule and parameter
names follow the reference's parameter tree (``embed``,
``layers.<i>.ln1``, ``layers.<i>.attn.wq``, ..., ``ln_f``,
``lm_head``, ``vision_proj``), so a state-dict key names its JAX leaf
with the layer index split out of the stacked axis.  The reference's
``lax.scan`` over stacked layers is a Python loop here.  One module
serves the dense (Yi, Qwen2, Qwen1.5), MLA (MiniCPM3), MoE (Moonshot,
Llama-4 Scout) and VLM (Qwen2-VL: projected vision patches merged into
the token stream, M-RoPE positions) families.

Training (:func:`loss_fn`) runs the layer loop through
:func:`repro_torch.models.scan_utils.stacked_scan`, checkpointed in groups
of ``cfg.remat_group`` layers, over a model loaded with
``trainable=True`` (f32 masters cast at use).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moelib
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
    mla_attend,
    mla_cache_specs,
    mla_decode,
    mla_specs,
    mlp,
    mlp_specs,
    mp,
    rmsnorm,
    rmsnorm_spec,
    shard_batch,
    softmax_xent,
    unembed,
)
from repro_torch.models.param import (
    Params, PSpec, f32_param, frozen, in_bf16, layer_group, master, spec_tree_map, stack,
)
from repro_torch.models.scan_utils import stacked_scan


def layer_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "ln1": rmsnorm_spec(d),
        "attn": mla_specs(cfg) if cfg.mla else attention_specs(cfg),
        "ln2": rmsnorm_spec(d),
        "ffn": moelib.moe_specs(cfg) if cfg.n_experts else mlp_specs(cfg),
    }


def param_specs(cfg: ModelConfig) -> dict:
    specs = {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        "layers": stack(cfg.n_layers, layer_specs(cfg)),
        "ln_f": rmsnorm_spec(cfg.d_model),
    }
    if cfg.vision_dim:
        specs["vision_proj"] = in_bf16(PSpec((cfg.vision_dim, cfg.d_model), (None, "model")))
    if not cfg.tie_embeddings:
        specs["lm_head"] = embed_spec(cfg.vocab_size, cfg.d_model)
    return specs


class DecoderLM(Params):
    """The decoder's parameters, loaded from a reference-shaped tree
    (stacked layer axis first).  Norm scales, the embedding and the LM
    head stay f32: ``rmsnorm`` and ``unembed`` read them in f32; so do the
    layer leaves in ``param.F32_LEAVES``.  ``trainable``: every leaf an f32
    master (``param.master``)."""

    def __init__(self, cfg: ModelConfig, tree: dict, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed = f32_param(tree["embed"], trainable)
        stacked = tree["layers"]
        layers = []
        for i in range(cfg.n_layers):
            layer = Params()
            layer.ln1 = f32_param(stacked["ln1"][i], trainable)
            layer.attn = layer_group(stacked["attn"], i, trainable)
            layer.ln2 = f32_param(stacked["ln2"][i], trainable)
            layer.ffn = layer_group(stacked["ffn"], i, trainable)
            layers.append(layer)
        self.layers = nn.ModuleList(layers)
        self.ln_f = f32_param(tree["ln_f"], trainable)
        if cfg.vision_dim:
            vp = tree["vision_proj"]
            self.vision_proj = master(vp) if trainable else frozen(mp(vp))
        if not cfg.tie_embeddings:
            self.lm_head = f32_param(tree["lm_head"], trainable)


def load(cfg: ModelConfig, tree: dict, trainable: bool = False) -> DecoderLM:
    return DecoderLM(cfg, tree, trainable)


def _ffn(cfg: ModelConfig, p, x):
    if cfg.n_experts:
        return moelib.moe_ffn(cfg, p, x)
    return mlp(cfg, p, x), torch.zeros((), device=x.device)


def _layer_train(cfg: ModelConfig, p, x, positions):
    x = shard_batch(x)
    normed = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.mla:
        x = x + mla_attend(cfg, p["attn"], normed, positions)[0]
    else:
        x = x + attention_train(cfg, p["attn"], normed, positions)
    f, aux = _ffn(cfg, p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + f, aux


def forward_train(cfg: ModelConfig, params, tokens, positions, extra=None):
    """Hidden states for a full sequence. Returns (hidden (B,S,D), aux), aux
    the router's load-balance loss summed over the layers (0 without MoE).

    ``extra`` (VLM): ``vision_embeds`` (B, P, vision_dim) projected by
    ``vision_proj`` and written over the token embeddings at
    ``vision_pos`` (B, P).
    """
    x = embed_lookup(params["embed"], tokens)
    if extra is not None and cfg.vision_dim:
        vis = torch.matmul(mp(extra["vision_embeds"]), mp(params["vision_proj"]))
        at = extra["vision_pos"].long()[..., None].expand(-1, -1, x.shape[-1])
        x = x.scatter(1, at, vis)
    x = shard_batch(x)
    body = functools.partial(_layer_train, cfg)
    x, aux = stacked_scan(body, x, params["layers"], cfg.remat_group, positions)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux


def logits_of(cfg: ModelConfig, params, hidden):
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return shard_batch(unembed(table, hidden), model_dim=-1)


def make_positions(cfg: ModelConfig, tokens):
    """Positions 0..S-1 for every row: (B, S), or (3, B, S) for M-RoPE,
    one stream repeated (text alone)."""
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    return pos.expand(3, B, S) if cfg.mrope else pos


def loss_fn(cfg: ModelConfig, params, batch):
    """(total, {"xent", "aux"}): the token-mean cross entropy plus
    ``router_aux_weight`` times the router's load-balance loss.  ``batch``:
    tokens, labels, and for the VLM ``positions`` (3, B, S),
    ``vision_embeds`` and ``vision_pos``."""
    tokens = batch["tokens"]
    positions = batch.get("positions")
    if positions is None:
        positions = make_positions(cfg, tokens)
    extra = {k: batch[k] for k in ("vision_embeds", "vision_pos") if k in batch} or None
    hidden, aux = forward_train(cfg, params, tokens, positions, extra)
    loss = softmax_xent(logits_of(cfg, params, hidden), batch["labels"])
    return loss + cfg.router_aux_weight * aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Decode (serve_step) — KV cache over the layers
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    per_layer = (mla_cache_specs(cfg, batch, s_max) if cfg.mla
                 else attention_cache_specs(cfg, batch, s_max))
    return {"layers": stack(cfg.n_layers, per_layer)}


def _empty_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> dict:
    return spec_tree_map(
        lambda ps: torch.zeros(ps.shape, dtype=ps.dtype, device=device),
        cache_specs(cfg, batch, s_max),
    )


def _layer_cache(cache: dict, i: int) -> dict:
    return {name: t[i] for name, t in cache["layers"].items()}


def _layer_decode(cfg: ModelConfig, p, cache, x, pos):
    step = mla_decode if cfg.mla else attention_decode
    a, cache = step(cfg, p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), cache, pos)
    x = x + a
    f, _ = _ffn(cfg, p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + f, cache


def decode_step(cfg: ModelConfig, params, cache, batch):
    """One-token decode. batch: tokens (B,1), pos (B,). Returns
    (logits (B,1,V), cache); the cache is updated in place.  M-RoPE
    rotates by ``pos`` in all three streams."""
    tokens, pos = batch["tokens"], batch["pos"]
    x = embed_lookup(params["embed"], tokens)
    for i, lp in enumerate(params["layers"]):
        x = shard_batch(x)
        x, _ = _layer_decode(cfg, lp, _layer_cache(cache, i), x, pos)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits_of(cfg, params, x), cache


def prefill(cfg: ModelConfig, params, tokens, s_max: int):
    """Run the prompt through the stack, returning (last-position logits
    (B,1,V), cache).

    Each layer's attention runs the flash kernel once.  GQA layers cache
    the rotated K and V they computed for it; MLA layers cache the normed
    latent and the rotated rope key.
    """
    B, S = tokens.shape
    positions = make_positions(cfg, tokens)
    x = embed_lookup(params["embed"], tokens)
    cache = _empty_cache(cfg, B, s_max, x.device)
    for i, lp in enumerate(params["layers"]):
        normed = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        entry = _layer_cache(cache, i)
        if cfg.mla:
            a, c_kv, k_rope = mla_attend(cfg, lp["attn"], normed, positions)
            entry["c_kv"][:, :S] = c_kv
            entry["k_rope"][:, :S] = k_rope
        else:
            q, k, v = _qkv(cfg, lp["attn"], normed)
            q, k = _apply_rope(cfg, q, k, positions)
            entry["k"][:, :, :S] = k.transpose(1, 2)
            entry["v"][:, :, :S] = v.transpose(1, 2)
            a = _attend(cfg, lp["attn"], q, k, v, x.dtype)
        x = x + a
        f, _ = _ffn(cfg, lp["ffn"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
        x = x + f
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits_of(cfg, params, x[:, -1:, :]), cache
