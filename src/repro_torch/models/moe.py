"""Mixture-of-Experts FFN: top-k token-choice routing with capacity.

The routing is the reference's step for step: an
f32 router, softmax, then top-k (the lower expert index first on ties),
the gates renormalised only when k > 1, each (token, choice) queued at
its expert in choice-major order (every token's first choice before any
second choice), and the tokens past the capacity
``C = int(g * k * 1.25 / E) + 1`` of their group of ``g = min(512, T)``
tokens dropped (gate 0).

Dispatch differs in form only: where the reference contracts one-hot
(g, E, C) dispatch and combine tensors, each kept (token, choice) is
copied by index into its slot of an (E, G * C, D) buffer, the experts
run as two batched GEMMs, and each token sums its kept slots' outputs
times their gates in f32.  Same slots, same gates, same sums.

The router's load-balance loss is the reference's: ``E * sum_e f_e p_e``
with f the dispatch fraction and p the mean router probability, averaged
over groups.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mp
from repro_torch.models.param import PSpec, in_bf16


def moe_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    e = cfg.n_experts
    specs = {
        "w_in": PSpec((e, d, 2 * f), ("model", "data", None)),
        "w_out": PSpec((e, f, d), ("model", None, "data")),
    }
    if cfg.n_shared_experts:
        fs = cfg.shared_d_ff or f * cfg.n_shared_experts
        specs["shared_w_in"] = PSpec((d, 2 * fs), ("data", "model"))
        specs["shared_w_out"] = PSpec((fs, d), ("model", "data"))
    return {"router": PSpec((d, e), (None, None), scale=0.02), **in_bf16(specs)}


GROUP_SIZE = 512  # tokens a routing group (the reference's default)


def _capacity(tokens_per_group: int, cfg: ModelConfig, factor: float = 1.25) -> int:
    k, e = cfg.experts_per_token, cfg.n_experts
    c = int(tokens_per_group * k * factor / e) + 1
    return max(c, k)


def top_k(probs, k: int):
    """(values, indices) of the k largest entries along the last axis, the
    lower index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, router, xt):
    """Token-choice routing of xt (G, g, D). Returns the router
    probabilities (G, g, E), the experts (G, g, K), the gates (G, g, K)
    with dropped choices at 0, and each choice's queue position (G, g, K)."""
    E, K = cfg.n_experts, cfg.experts_per_token
    G, g, _ = xt.shape
    probs = torch.softmax(torch.matmul(xt.float(), router.float()), dim=-1)
    gate, idx = top_k(probs, K)
    if K > 1:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(idx, E)  # (G, g, K, E)
    prio = onehot.transpose(1, 2).reshape(G, K * g, E)  # choice-major
    pos = (prio.cumsum(dim=1) - prio).reshape(G, K, g, E).transpose(1, 2)
    within = (pos * onehot).sum(dim=-1)  # (G, g, K)
    gate = gate * (within < _capacity(g, cfg))
    return probs, idx, gate, within


def moe_ffn(cfg: ModelConfig, p, x, *, group_size: int = GROUP_SIZE):
    """x (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    g = min(group_size, T)
    G = T // g
    assert G * g == T, f"tokens {T} not divisible by group {g}"
    xt = x.reshape(G, g, D)
    probs, idx, gate, within = route(cfg, p["router"], xt)
    C = _capacity(g, cfg)
    keep = within < C

    # slot of each (token, choice) in the (E, G, C) expert buffer; every
    # dropped choice goes to one spare row past its end (no host sync to
    # count the kept ones)
    group = torch.arange(G, device=x.device)[:, None, None]
    slot = ((idx * G + group) * C + within.clamp(max=C - 1)).reshape(-1)
    kept = keep.reshape(-1)
    spare = E * G * C
    expert_in = torch.zeros((spare + 1, D), dtype=mp(x).dtype, device=x.device)
    expert_in.index_copy_(0, torch.where(kept, slot, spare),
                          mp(x).reshape(T, D).repeat_interleave(K, dim=0))
    f = p["w_out"].shape[1]
    h = torch.bmm(expert_in[:spare].reshape(E, G * C, D), mp(p["w_in"]))
    h = F.silu(h[..., :f].float()).to(h.dtype) * h[..., f:]
    expert_out = torch.bmm(h, mp(p["w_out"])).reshape(E * G * C, D)
    # a dropped choice points at slot C - 1 of its expert; it adds 0
    picked = expert_out[slot].float().reshape(T, K, D)
    picked = torch.where(kept.reshape(T, K, 1), picked, 0.0)
    out = (gate.reshape(T, K, 1) * picked).sum(dim=1)
    out = out.reshape(B, S, D).to(x.dtype)

    # load-balance aux loss
    frac = F.one_hot(idx, E).sum(dim=2).float().mean(dim=1)  # (G, E) dispatch fraction
    pmean = probs.mean(dim=1)  # (G, E)
    aux = E * (frac * pmean).sum(dim=-1).mean()

    if cfg.n_shared_experts:
        fs = p["shared_w_out"].shape[0]
        gu = torch.matmul(x, mp(p["shared_w_in"]))
        sh = F.silu(gu[..., :fs].float()).to(x.dtype) * gu[..., fs:]
        out = out + torch.matmul(sh, mp(p["shared_w_out"]))
    return out, aux
