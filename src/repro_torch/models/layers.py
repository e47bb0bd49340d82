"""Transformer building blocks (bf16 compute): GQA, MLA and cross
attention, RoPE and M-RoPE, RMSNorm and LayerNorm, the MLP.

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
(``shard_batch``, ``shard_spec``) have no counterpart here; they come
with the multi-device slice (``ROADMAP.md`` Queue 1 item 15).
"""

from __future__ import annotations

import functools
import math
import os

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn import ops as flash
from repro_torch.models.param import PSpec, in_bf16

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e9

# CPU tensors longer than this take the query-block-chunked plain path
# (a (q_block, T) score tile live at a time instead of (S, T)); CUDA
# tensors always take the flash kernel.
ATTN_CHUNK_THRESHOLD = int(os.environ.get("REPRO_ATTN_CHUNK_THRESHOLD", 4096))
ATTN_Q_BLOCK = int(os.environ.get("REPRO_ATTN_Q_BLOCK", 1024))


def mp(x):
    """Cast to the compute (mixed-precision) dtype; a no-op on bf16 weights."""
    return x.to(COMPUTE_DTYPE)


def mixed_einsum(spec, a, b):
    """bf16 x bf16 -> f32 contraction, with the operands upcast first (the
    reference's CPU form).  On CUDA float32 products run in full float32."""
    return torch.einsum(spec, a.float(), b.float())


# ---------------------------------------------------------------------------
# Norms / embeddings
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> PSpec:
    return PSpec((d,), (), init="ones")


def rmsnorm(scale, x, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm_spec(d: int) -> dict:
    return {"scale": PSpec((d,), (), init="ones"), "bias": PSpec((d,), (), init="zeros")}


def layernorm(p, x, eps: float = 1e-5):
    """LayerNorm with bias (Whisper); statistics, scale and bias in f32."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def embed_spec(vocab: int, d: int) -> PSpec:
    return PSpec((vocab, d), ("model", None), init="embed", scale=0.02)


def embed_lookup(table, ids):
    return mp(torch.index_select(table, 0, ids.reshape(-1)).reshape(*ids.shape, -1))


def unembed(table, x):
    """Logits in f32 from the f32 table."""
    return torch.matmul(x.float(), table.float().T)


def softmax_xent(logits, labels, mask=None):
    """Token-mean cross entropy in f32. labels (B,S) int, mask (B,S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


# ---------------------------------------------------------------------------
# Rotary position embeddings (RoPE + M-RoPE)
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


@functools.lru_cache(maxsize=None)
def _mrope_streams(half: int, sections: tuple[int, int, int], device) -> torch.Tensor:
    """The position stream of each of the ``half`` frequency channels, made
    once a device (no host-to-device copy a call)."""
    bounds = torch.cumsum(torch.tensor(sections), 0)
    return torch.searchsorted(bounds, torch.arange(half), right=True).clamp(0, 2).to(device)


def mrope(x, positions3, theta: float, sections: tuple[int, int, int]):
    """Multimodal RoPE (Qwen2-VL): positions3 (3, B, S) are the temporal,
    height and width position ids; the frequency channels are split into
    three sections, each rotated by its own position stream."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)  # (hd/2,)
    which = _mrope_streams(hd // 2, tuple(sections), x.device)  # (hd/2,)
    pos = positions3[which].movedim(0, -1).float()  # (B, S, hd/2): per-channel stream
    ang = pos * freqs
    cos = torch.cos(ang)[..., None, :]
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
    return in_bf16(p)


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
        secs = cfg.mrope_sections
        return mrope(q, positions, cfg.rope_theta, secs), mrope(k, positions, cfg.rope_theta, secs)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta)


def chunked_attention(q, k, v, scale, *, causal=True, q_block: int | None = None,
                      out_dtype=None):
    """Query-block-chunked exact attention, the long-sequence plain path.

    q (B,S,H,hq), k (B,T,Hkv,hq), v (B,T,Hkv,hv) -> (B,S,H*hv).  Each
    query block takes its full-row softmax against all T keys, so the
    result is the unchunked one; only a (q_block, T) score tile is live.
    """
    B, S, H, hq = q.shape
    T, hkv = k.shape[1], k.shape[2]
    g = H // hkv
    hv = v.shape[-1]
    out_dtype = out_dtype or v.dtype
    qb = min(q_block or ATTN_Q_BLOCK, S)
    nb = S // qb
    assert nb * qb == S, f"seq {S} not divisible by q_block {qb}"
    rows0 = torch.arange(qb, device=q.device)
    cols = torch.arange(T, device=q.device)
    out = []
    for blk in range(nb):
        qblk = q[:, blk * qb:(blk + 1) * qb].reshape(B, qb, hkv, g, hq)
        s = mixed_einsum("bskgh,btkh->bkgst", qblk, k) * scale
        if causal:
            m = (blk * qb + rows0)[:, None] >= cols[None, :]
            s = torch.where(m, s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        o = mixed_einsum("bkgst,btkh->bskgh", pr.to(v.dtype), v)
        out.append(o.reshape(B, qb, H * hv).to(out_dtype))
    return torch.cat(out, dim=1)


def attend(q, k, v, scale, out_dtype, *, causal: bool = True):
    """Full-sequence attention, q (B,S,H,hq), k (B,T,Hkv,hq), v (B,T,Hkv,hv)
    -> (B,S,H*hv) in ``out_dtype``: the ``flash_attn`` kernel (its plain
    version on CPU tensors), or :func:`chunked_attention` on CPU tensors
    longer than ``ATTN_CHUNK_THRESHOLD``.

    The kernel takes one head dim from ``flash.HEAD_DIMS`` for q, k and v.
    Other dims (MLA's 96 for q.k and 64 for v) are zero-padded to the
    smallest one that holds both, which leaves q.k unchanged; each head's
    first ``hv`` output columns are kept.
    """
    S, hq, hv = q.shape[1], q.shape[-1], v.shape[-1]
    if q.device.type == "cpu" and S > ATTN_CHUNK_THRESHOLD:
        return chunked_attention(q, k, v, scale, causal=causal, out_dtype=out_dtype)
    if hq == hv and hq in flash.HEAD_DIMS:
        return flash.attention(q, k, v, scale, causal=causal).to(out_dtype)
    hd = min(d for d in flash.HEAD_DIMS if d >= max(hq, hv))
    q, k, v = (F.pad(t, (0, hd - t.shape[-1])) for t in (q, k, v))
    o = flash.attention(q, k, v, scale, causal=causal)
    B, H = o.shape[0], q.shape[2]
    return o.reshape(B, S, H, hd)[..., :hv].reshape(B, S, H * hv).to(out_dtype)


def _attend(cfg: ModelConfig, p, q, k, v, out_dtype, *, causal: bool = True):
    """Attention over rotated q/k and v, then the output projection."""
    o = attend(q, k, v, 1.0 / math.sqrt(cfg.head_dim), out_dtype, causal=causal)
    return torch.matmul(o, mp(p["wo"]))


def attention_train(cfg: ModelConfig, p, x, positions, *, causal: bool = True):
    """Full-sequence attention. x (B,S,D) bf16, positions (B,S) or (3,B,S)."""
    q, k, v = _qkv(cfg, p, x)
    q, k = _apply_rope(cfg, q, k, positions)
    return _attend(cfg, p, q, k, v, x.dtype, causal=causal)


def cross_attention_train(cfg: ModelConfig, p, x, memory):
    """Encoder-decoder cross attention, x (B,S,D) over memory (B,T,D): no
    positions, no mask, and, as in the reference, no q/k/v biases (the
    decode path's cross cache and query add them)."""
    B, S, _ = x.shape
    T = memory.shape[1]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.matmul(x, mp(p["wq"])).reshape(B, S, h, hd)
    k = torch.matmul(memory, mp(p["wk"])).reshape(B, T, hkv, hd)
    v = torch.matmul(memory, mp(p["wv"])).reshape(B, T, hkv, hd)
    return _attend(cfg, p, q, k, v, x.dtype, causal=False)


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


def decode_positions(cfg: ModelConfig, pos):
    """The rotary positions of one decode step: (B, 1), or for M-RoPE the
    same position in all three streams, (3, B, 1)."""
    if cfg.mrope:
        return pos[None, :, None].expand(3, pos.shape[0], 1)
    return pos[:, None]


def attention_decode(cfg: ModelConfig, p, x, cache, pos):
    """Single-token decode. x (B,1,D), cache {k,v} (B,Hkv,S,hd), pos (B,).

    The new key and value are written at ``pos[0]`` for every row, as
    the reference's ``dynamic_update_slice`` does (its start index is
    clamped into range), but in place: the returned cache is the given
    one.  The scores and the PV product are f32 over upcast operands.
    """
    B = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(cfg, p, x)  # (B,1,.,hd)
    q, k = _apply_rope(cfg, q, k, decode_positions(cfg, pos))
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
# MLA: multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------


def mla_specs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        **in_bf16({
            "q_down": PSpec((d, qr), (None, None)),
            "q_up": PSpec((qr, h * (dn + dr)), (None, "model")),
            "kv_down": PSpec((d, kr + dr), (None, None)),
            "kv_up": PSpec((kr, h * (dn + dv)), (None, "model")),
            "wo": PSpec((h * dv, d), ("model", None)),
        }),
        "q_norm": rmsnorm_spec(qr),
        "kv_norm": rmsnorm_spec(kr),
    }


def _mla_q(cfg: ModelConfig, p, x):
    """The query's no-rope and rope parts, (B,S,h,dn) and (B,S,h,dr), unrotated."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    ql = rmsnorm(p["q_norm"], torch.matmul(x, mp(p["q_down"])), cfg.norm_eps)
    q = torch.matmul(ql, mp(p["q_up"])).reshape(B, S, cfg.n_heads, dn + dr)
    return q[..., :dn], q[..., dn:]


def _mla_latent(cfg: ModelConfig, p, x, positions):
    """The normed latent c_kv (B,S,kr) and the rotated rope key (B,S,dr):
    what the decode cache holds."""
    kr = cfg.kv_lora_rank
    kv = torch.matmul(x, mp(p["kv_down"]))
    c_kv = rmsnorm(p["kv_norm"], kv[..., :kr], cfg.norm_eps)
    k_rope = rope(kv[..., kr:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_attend(cfg: ModelConfig, p, x, positions):
    """Full-sequence MLA. Returns (out (B,S,D), c_kv, k_rope); the latent
    and the rope key are the prefill's cache entries."""
    B, S, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(cfg, p, x)
    c_kv, k_rope = _mla_latent(cfg, p, x, positions)
    kvu = torch.matmul(c_kv, mp(p["kv_up"])).reshape(B, S, h, dn + dv)
    k_nope, v = kvu[..., :dn], kvu[..., dn:]
    q = torch.cat([q_nope, rope(q_rope, positions, cfg.rope_theta)], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, h, dr)], dim=-1)
    o = attend(q, k, v, 1.0 / math.sqrt(dn + dr), x.dtype)
    return torch.matmul(o, mp(p["wo"])), c_kv, k_rope


def mla_train(cfg: ModelConfig, p, x, positions):
    return mla_attend(cfg, p, x, positions)[0]


def mla_cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    """MLA caches the compressed latent and the rope key: kv_lora_rank +
    qk_rope_dim values a token instead of 2 * n_heads * head_dim."""
    seq = ("data", "model") if batch == 1 else "model"
    b_ax = None if batch == 1 else "data"
    return {
        "c_kv": PSpec((batch, s_max, cfg.kv_lora_rank), (b_ax, seq, None),
                      init="zeros", dtype=COMPUTE_DTYPE),
        "k_rope": PSpec((batch, s_max, cfg.qk_rope_dim), (b_ax, seq, None),
                        init="zeros", dtype=COMPUTE_DTYPE),
    }


def mla_decode(cfg: ModelConfig, p, x, cache, pos):
    """Absorbed-projection MLA decode: attention runs in the latent space
    (W_uk folded into q, W_uv applied after the probability-weighted
    latent sum).  The new latent and rope key are written in place at
    ``pos[0]``, clamped, as in :func:`attention_decode`."""
    B = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(cfg, p, x)
    q_rope = rope(q_rope, pos[:, None], cfg.rope_theta)
    c_new, kr_new = _mla_latent(cfg, p, x, pos[:, None])
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    S = c_cache.shape[1]
    at = pos[:1].long().clamp(0, S - 1)
    c_cache.index_copy_(1, at, c_new.to(c_cache.dtype))
    r_cache.index_copy_(1, at, kr_new.to(r_cache.dtype))

    kv_up = p["kv_up"].reshape(kr, h, dn + dv)
    w_uk = mp(kv_up[..., :dn])  # (kr, h, dn)
    w_uv = mp(kv_up[..., dn:])  # (kr, h, dv)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)  # (B,1,h,kr)
    s_lat = mixed_einsum("bshr,btr->bhst", q_lat.to(c_cache.dtype), c_cache)
    s_rope = mixed_einsum("bshd,btd->bhst", q_rope.to(r_cache.dtype), r_cache)
    scores = (s_lat + s_rope) * (1.0 / math.sqrt(dn + dr))
    tmask = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    scores = torch.where(tmask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    lat = mixed_einsum("bhst,btr->bshr", probs.to(c_cache.dtype), c_cache)  # (B,1,h,kr)
    o = torch.einsum("bshr,rhd->bshd", lat, w_uv.float())
    o = o.reshape(B, 1, h * dv).to(x.dtype)
    return torch.matmul(o, mp(p["wo"])), cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act == "silu":  # gated: fused [gate; up]
        return in_bf16({
            "w_in": PSpec((d, 2 * f), (None, "model")),
            "w_out": PSpec((f, d), ("model", None)),
        })
    return in_bf16({
        "w_in": PSpec((d, f), (None, "model")),
        "b_in": PSpec((f,), ("model",), init="zeros"),
        "w_out": PSpec((f, d), ("model", None)),
        "b_out": PSpec((d,), (), init="zeros"),
    })


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
