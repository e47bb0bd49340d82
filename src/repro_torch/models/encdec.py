"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The conv feature extractor is a stub, as in the reference: the inputs
carry precomputed frame embeddings ``(B, encoder_frames, d_model)``.
Encoder: bidirectional self-attention and a GELU MLP, pre-LayerNorm
(LayerNorm with bias).  Decoder: causal self-attention, cross-attention
over the encoder memory, a GELU MLP.  Positions are learned tables.

Every full-sequence attention (the encoder's, non-causal; the decoder's
causal self-attention; the cross attention) runs the ``flash_attn``
kernel.  Decode caches the growing self-attention KV and the static
cross-attention KV (:func:`build_cross_cache`, once a request); decode
attention is plain tensor code.  As in the reference there is no
``prefill``: a prompt is fed as decode steps.

The reference's own asymmetry is kept on purpose: the cross attention of
:func:`decode_train` adds no q/k/v biases, while :func:`build_cross_cache`
adds ``bk``/``bv`` and :func:`_cross_decode` adds ``bq``.  With nonzero
biases the two paths give different logits for the same tokens.

Training (:func:`loss_fn`) checkpoints the encoder's and the decoder's
layer loops in groups of ``cfg.remat_group``
(:mod:`repro_torch.models.scan_utils`).
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    attention_cache_specs,
    attention_decode,
    attention_specs,
    attention_train,
    cross_attention_train,
    embed_lookup,
    embed_spec,
    layernorm,
    layernorm_spec,
    mixed_einsum,
    mlp,
    mlp_specs,
    mp,
    row_project,
    softmax_xent,
    shard_batch,
    unembed,
)
from repro_torch.models.param import Params, PSpec, f32_param, layer_group, stack
from repro_torch.models.scan_utils import stacked_scan


def enc_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": layernorm_spec(cfg.d_model),
        "attn": attention_specs(cfg),
        "ln2": layernorm_spec(cfg.d_model),
        "ffn": mlp_specs(cfg),
    }


def dec_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": layernorm_spec(cfg.d_model),
        "self_attn": attention_specs(cfg),
        "ln_x": layernorm_spec(cfg.d_model),
        "cross_attn": attention_specs(cfg),
        "ln2": layernorm_spec(cfg.d_model),
        "ffn": mlp_specs(cfg),
    }


def param_specs(cfg: ModelConfig) -> dict:
    return {
        "enc_pos": PSpec((cfg.encoder_frames, cfg.d_model), (None, "model"), scale=0.02),
        "enc_layers": stack(cfg.encoder_layers, enc_layer_specs(cfg)),
        "enc_ln_f": layernorm_spec(cfg.d_model),
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        "dec_pos": PSpec((cfg.max_position_embeddings, cfg.d_model), (None, "model"),
                         scale=0.02),
        "dec_layers": stack(cfg.n_layers, dec_layer_specs(cfg)),
        "dec_ln_f": layernorm_spec(cfg.d_model),
    }


def _norm(src: dict, i: int | None = None, trainable: bool = False) -> Params:
    """A LayerNorm's scale and bias in f32 (layer ``i`` of a stacked one)."""
    g = Params()
    for name in ("scale", "bias"):
        t = src[name] if i is None else src[name][i]
        g.register_parameter(name, f32_param(t.clone(), trainable))
    return g


class EncDecLM(Params):
    """The encoder-decoder's parameters from a reference-shaped tree:
    ``enc_layers.<i>.{ln1, attn, ln2, ffn}``, ``dec_layers.<i>.{ln1,
    self_attn, ln_x, cross_attn, ln2, ffn}``.  The learned positions,
    LayerNorm scales and biases and the (tied) embedding stay f32
    (``trainable``: every leaf an f32 master)."""

    def __init__(self, cfg: ModelConfig, tree: dict, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.enc_pos = f32_param(tree["enc_pos"], trainable)
        self.embed = f32_param(tree["embed"], trainable)
        self.dec_pos = f32_param(tree["dec_pos"], trainable)
        self.enc_layers = nn.ModuleList(
            self._layer(tree["enc_layers"], i, ("ln1", "ln2"), ("attn", "ffn"), trainable)
            for i in range(cfg.encoder_layers))
        self.enc_ln_f = _norm(tree["enc_ln_f"], trainable=trainable)
        self.dec_layers = nn.ModuleList(
            self._layer(tree["dec_layers"], i, ("ln1", "ln_x", "ln2"),
                        ("self_attn", "cross_attn", "ffn"), trainable)
            for i in range(cfg.n_layers))
        self.dec_ln_f = _norm(tree["dec_ln_f"], trainable=trainable)

    @staticmethod
    def _layer(stacked: dict, i: int, norms, groups, trainable: bool) -> Params:
        layer = Params()
        for name in norms:
            setattr(layer, name, _norm(stacked[name], i, trainable))
        for name in groups:
            setattr(layer, name, layer_group(stacked[name], i, trainable))
        return layer


def load(cfg: ModelConfig, tree: dict, trainable: bool = False) -> EncDecLM:
    return EncDecLM(cfg, tree, trainable)


def _attn_full(cfg: ModelConfig, p, x, *, causal: bool):
    """Self-attention over the whole sequence (no rotary positions)."""
    return attention_train(cfg, p, x, None, causal=causal)


def _enc_layer(cfg: ModelConfig, lp, x):
    x = shard_batch(x)
    x = x + _attn_full(cfg, lp["attn"], layernorm(lp["ln1"], x, cfg.norm_eps), causal=False)
    x = x + mlp(cfg, lp["ffn"], layernorm(lp["ln2"], x, cfg.norm_eps))
    return x, torch.zeros((), device=x.device)


def encode(cfg: ModelConfig, params, frames):
    """frames (B, F, D) stub embeddings -> encoder memory (B, F, D) bf16."""
    x = mp(frames) + mp(params["enc_pos"][: frames.shape[1]])[None]
    x, _ = stacked_scan(functools.partial(_enc_layer, cfg), x, params["enc_layers"],
                        cfg.remat_group)
    return layernorm(params["enc_ln_f"], x, cfg.norm_eps)


def _dec_layer_train(cfg: ModelConfig, lp, x, memory):
    x = shard_batch(x)
    x = x + _attn_full(cfg, lp["self_attn"], layernorm(lp["ln1"], x, cfg.norm_eps), causal=True)
    x = x + cross_attention_train(
        cfg, lp["cross_attn"], layernorm(lp["ln_x"], x, cfg.norm_eps), memory)
    x = x + mlp(cfg, lp["ffn"], layernorm(lp["ln2"], x, cfg.norm_eps))
    return x, torch.zeros((), device=x.device)


def decode_train(cfg: ModelConfig, params, tokens, memory):
    """Decoder hidden states (B, S, D) of a full token sequence over the
    encoder memory."""
    S = tokens.shape[1]
    x = embed_lookup(params["embed"], tokens) + mp(params["dec_pos"][:S])[None]
    x, _ = stacked_scan(functools.partial(_dec_layer_train, cfg), x, params["dec_layers"],
                        cfg.remat_group, memory)
    return layernorm(params["dec_ln_f"], x, cfg.norm_eps)


def loss_fn(cfg: ModelConfig, params, batch):
    memory = encode(cfg, params, batch["frames"])
    hidden = decode_train(cfg, params, batch["tokens"], memory)
    loss = softmax_xent(logits_of(cfg, params, hidden), batch["labels"])
    return loss, {"xent": loss, "aux": torch.zeros((), device=loss.device)}


def logits_of(cfg: ModelConfig, params, hidden):
    return shard_batch(unembed(params["embed"], hidden), model_dim=-1)


# ---------------------------------------------------------------------------
# Decode with self-KV + static cross-KV caches
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    self_kv = attention_cache_specs(cfg, batch, s_max)
    shape = (batch, cfg.n_kv_heads, cfg.encoder_frames, cfg.head_dim)
    spec = ("data", "model", None, None)
    cross = {
        "k": PSpec(shape, spec, init="zeros", dtype=COMPUTE_DTYPE),
        "v": PSpec(shape, spec, init="zeros", dtype=COMPUTE_DTYPE),
    }
    return {"layers": stack(cfg.n_layers, {"self": self_kv, "cross": cross})}


def build_cross_cache(cfg: ModelConfig, params, memory):
    """Each decoder layer's cross-attention K and V of the encoder memory
    (B, F, D): {k, v} (n_layers, B, Hkv, F, hd) bf16, biases added."""
    B, F, _ = memory.shape
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    ks, vs = [], []
    for lp in params["dec_layers"]:
        p = lp["cross_attn"]
        k = torch.matmul(memory, mp(p["wk"]))
        v = torch.matmul(memory, mp(p["wv"]))
        if cfg.qkv_bias:
            k = k + mp(p["bk"])
            v = v + mp(p["bv"])
        ks.append(k.reshape(B, F, hkv, hd).transpose(1, 2).to(COMPUTE_DTYPE))
        vs.append(v.reshape(B, F, hkv, hd).transpose(1, 2).to(COMPUTE_DTYPE))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def _cross_decode(cfg: ModelConfig, p, x, cross):
    """One token's cross attention over a layer's cached K and V."""
    B = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.matmul(x, mp(p["wq"]))
    if cfg.qkv_bias:
        q = q + mp(p["bq"])
    qg = q.reshape(B, 1, hkv, h // hkv, hd)
    scores = mixed_einsum("bskgh,bkth->bkgst", qg.to(cross["k"].dtype), cross["k"]) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    o = mixed_einsum("bkgst,bkth->bskgh", probs.to(cross["v"].dtype), cross["v"])
    o = o.reshape(B, 1, h * hd).to(x.dtype)
    return row_project(o, p["wo"])


def decode_step(cfg: ModelConfig, params, cache, batch):
    """One-token decode. batch: tokens (B,1), pos (B,); the cross K/V
    already in the cache.  Returns (logits (B,1,V), cache); the self KV is
    written in place at ``pos[0]``, the position row read at ``pos[0]``
    (clamped, as ``dynamic_slice`` does)."""
    tokens, pos = batch["tokens"], batch["pos"]
    table = params["dec_pos"]
    at = pos[:1].long().clamp(0, table.shape[0] - 1)
    x = embed_lookup(params["embed"], tokens) + mp(torch.index_select(table, 0, at))
    layers = cache["layers"]
    for i, lp in enumerate(params["dec_layers"]):
        self_c = {name: t[i] for name, t in layers["self"].items()}
        cross_c = {name: t[i] for name, t in layers["cross"].items()}
        out, _ = attention_decode(cfg, lp["self_attn"], layernorm(lp["ln1"], x, cfg.norm_eps),
                                  self_c, pos)
        x = x + out
        x = x + _cross_decode(cfg, lp["cross_attn"], layernorm(lp["ln_x"], x, cfg.norm_eps),
                              cross_c)
        x = x + mlp(cfg, lp["ffn"], layernorm(lp["ln2"], x, cfg.norm_eps))
    x = layernorm(params["dec_ln_f"], x, cfg.norm_eps)
    return logits_of(cfg, params, x), cache
