"""Transformer building blocks of the dense family (bf16 compute).

Conventions, the reference's (``repro.models.layers``):
  * parameters are read as ``p[name]``, from a plain dict of tensors or
    from the model's modules (:class:`repro_torch.models.transformer.
    DecoderLM`), which hold the same names;
  * activations are bf16; norms, RoPE, the SiLU gate, softmax and the
    logits are computed in f32 and cast back;
  * attention keeps an explicit GQA grouping (no repeated KV heads);
    every full-sequence attention runs the ``flash_attn`` kernel;
  * decode uses a KV cache ``[B, n_kv, S_max, hd]`` written at ``pos[0]``.

One device has no mesh, so the reference's sharding pins
(``shard_batch``, ``shard_spec``) have no counterpart here.  MLA,
M-RoPE, cross attention, ``layernorm``, ``chunked_attention`` and
``softmax_xent`` wait for the families and the training slice that use
them (``ROADMAP.md`` Queue 1 items 10 and 11).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn import ops as flash
from repro_torch.models.param import PSpec

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e9


def mp(x):
    """Cast to the compute (mixed-precision) dtype; a no-op on bf16 weights."""
    return x.to(COMPUTE_DTYPE)


def mixed_einsum(spec, a, b):
    """bf16 x bf16 -> f32 contraction, with the operands upcast first (the
    reference's CPU form).  On CUDA float32 products run in full float32."""
    return torch.einsum(spec, a.float(), b.float())


def unported(what: str, item: int = 10):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md Queue 1 item {item})")


# ---------------------------------------------------------------------------
# Norms / embeddings
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> PSpec:
    return PSpec((d,), (), init="ones")


def rmsnorm(scale, x, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def embed_spec(vocab: int, d: int) -> PSpec:
    return PSpec((vocab, d), ("model", None), init="embed", scale=0.02)


def embed_lookup(table, ids):
    return mp(torch.index_select(table, 0, ids.reshape(-1)).reshape(*ids.shape, -1))


def unembed(table, x):
    """Logits in f32 from the f32 table."""
    return torch.matmul(x.float(), table.float().T)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def _rope_freqs(dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def rope(x, positions, theta: float):
    """x (..., S, H, hd), positions (..., S) -> rotated x (same dtype)."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def attention_specs(cfg: ModelConfig) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": PSpec((d, h * hd), (None, "model")),
        "wk": PSpec((d, hkv * hd), (None, "model")),
        "wv": PSpec((d, hkv * hd), (None, "model")),
        "wo": PSpec((h * hd, d), ("model", None)),
    }
    if cfg.qkv_bias:
        p["bq"] = PSpec((h * hd,), ("model",), init="zeros")
        p["bk"] = PSpec((hkv * hd,), ("model",), init="zeros")
        p["bv"] = PSpec((hkv * hd,), ("model",), init="zeros")
    return p


def _qkv(cfg: ModelConfig, p, x):
    B, S, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.matmul(x, mp(p["wq"]))
    k = torch.matmul(x, mp(p["wk"]))
    v = torch.matmul(x, mp(p["wv"]))
    if cfg.qkv_bias:
        q = q + mp(p["bq"])
        k = k + mp(p["bk"])
        v = v + mp(p["bv"])
    return q.reshape(B, S, h, hd), k.reshape(B, S, hkv, hd), v.reshape(B, S, hkv, hd)


def _apply_rope(cfg: ModelConfig, q, k, positions):
    if not cfg.use_rope:
        return q, k
    if cfg.mrope:
        raise unported("M-RoPE (the VLM family)")
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta)


def _attend(cfg: ModelConfig, p, q, k, v, out_dtype, *, causal: bool = True):
    """The flash kernel over rotated q/k and v, then the output projection."""
    o = flash.attention(q, k, v, 1.0 / math.sqrt(cfg.head_dim), causal=causal)
    return torch.matmul(o.to(out_dtype), mp(p["wo"]))


def attention_train(cfg: ModelConfig, p, x, positions, *, causal: bool = True):
    """Full-sequence attention. x (B,S,D) bf16, positions (B,S)."""
    if cfg.mla:
        raise unported("MLA attention")
    q, k, v = _qkv(cfg, p, x)
    q, k = _apply_rope(cfg, q, k, positions)
    return _attend(cfg, p, q, k, v, x.dtype, causal=causal)


def attention_cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    """bf16 KV cache (B, Hkv, s_max, hd) a layer, with the reference's
    logical axes: batch on data and heads or sequence on model."""
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    if batch == 1:
        spec = (None, None, ("data", "model"), None)
    elif hkv >= 16 and hkv % 16 == 0:
        spec = ("data", "model", None, None)
    else:
        spec = ("data", None, "model", None)
    return {
        "k": PSpec((batch, hkv, s_max, hd), spec, init="zeros", dtype=COMPUTE_DTYPE),
        "v": PSpec((batch, hkv, s_max, hd), spec, init="zeros", dtype=COMPUTE_DTYPE),
    }


def attention_decode(cfg: ModelConfig, p, x, cache, pos):
    """Single-token decode. x (B,1,D), cache {k,v} (B,Hkv,S,hd), pos (B,).

    The new key and value are written at ``pos[0]`` for every row, as
    the reference's ``dynamic_update_slice`` does (its start index is
    clamped into range), but in place: the returned cache is the given
    one.  The scores and the PV product are f32 over upcast operands.
    """
    if cfg.mla:
        raise unported("MLA attention")
    B = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(cfg, p, x)  # (B,1,.,hd)
    q, k = _apply_rope(cfg, q, k, pos[:, None])
    kc, vc = cache["k"], cache["v"]
    S = kc.shape[2]
    at = pos[:1].long().clamp(0, S - 1)
    kc.index_copy_(2, at, k.transpose(1, 2).to(kc.dtype))
    vc.index_copy_(2, at, v.transpose(1, 2).to(vc.dtype))
    g = h // hkv
    qg = q.reshape(B, 1, hkv, g, hd).to(kc.dtype)
    # a Python scalar: a device tensor made from one would cost a host sync a layer
    scores = mixed_einsum("bskgh,bkth->bkgst", qg, kc) / math.sqrt(hd)  # (B,hkv,g,1,S)
    tmask = torch.arange(S, device=x.device)[None, :] <= pos[:, None]  # (B,S)
    scores = torch.where(tmask[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o = mixed_einsum("bkgst,bkth->bskgh", probs.to(vc.dtype), vc)
    o = o.reshape(B, 1, h * hd).to(x.dtype)
    return torch.matmul(o, mp(p["wo"])), cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act == "silu":  # gated: fused [gate; up]
        return {
            "w_in": PSpec((d, 2 * f), (None, "model")),
            "w_out": PSpec((f, d), ("model", None)),
        }
    return {
        "w_in": PSpec((d, f), (None, "model")),
        "b_in": PSpec((f,), ("model",), init="zeros"),
        "w_out": PSpec((f, d), ("model", None)),
        "b_out": PSpec((d,), (), init="zeros"),
    }


def mlp(cfg: ModelConfig, p, x):
    if cfg.act == "silu":
        f = p["w_out"].shape[0]
        gu = torch.matmul(x, mp(p["w_in"]))
        gate, up = gu[..., :f], gu[..., f:]
        h = F.silu(gate.float()).to(x.dtype) * up
    else:
        h = torch.matmul(x, mp(p["w_in"])) + mp(p["b_in"])
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)  # jax.nn.gelu's default
    out = torch.matmul(h, mp(p["w_out"]))
    if cfg.act != "silu":
        out = out + mp(p["b_out"])
    return out
