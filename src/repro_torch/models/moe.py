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

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    _contiguous_grads, _is_dtensor, _partial_where_split, gated, mp, row_project,
)
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
    if _is_dtensor(x):
        return _moe_expert_parallel(cfg, p, x, group_size)
    g = min(group_size, x.shape[0] * x.shape[1])
    out, aux = _experts(cfg, p["router"], p["w_in"], p["w_out"], x, g)
    return _shared(cfg, p, x, out.to(x.dtype)), aux


def _shared(cfg: ModelConfig, p, x, out):
    if cfg.n_shared_experts:
        fs = p["shared_w_out"].shape[0]
        if _is_dtensor(x):
            sh = gated(x, p["shared_w_in"])
        else:
            gu = torch.matmul(x, mp(p["shared_w_in"]))
            sh = F.silu(gu[..., :fs].float()).to(x.dtype) * gu[..., fs:]
        out = out + row_project(sh, p["shared_w_out"])
    return out


def _moe_expert_parallel(cfg: ModelConfig, p, x, group_size: int):
    """:func:`moe_ffn` over a mesh: each rank routes its rows of the batch
    (all rows where its share would split a routing group: a decode step's
    few tokens) and runs the experts it holds; the ``model`` ranks' partial
    outputs are summed in f32.  The expert weights keep the reference's
    layout over ``model`` (experts) and are gathered over ``data`` at use,
    as its compiler gathers them.  The reference pins its dispatch and
    combine tensors (experts on ``model``, groups on the data-parallel
    axes); here those are each rank's local buffers, laid out so by
    construction."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    m = sizes.get("model", 1)
    by_model = m > 1 and cfg.n_experts % m == 0

    weight_pl = [Shard(0) if n == "model" and by_model else Replicate() for n in names]
    w_in = p["w_in"].redistribute(mesh, weight_pl)
    w_out = p["w_out"].redistribute(mesh, weight_pl)
    router = p["router"].redistribute(mesh, [Replicate()] * len(names))
    g = min(group_size, x.shape[0] * x.shape[1])
    x_pl = [pl if pl.is_shard(0) else Replicate() for pl in x.placements]
    rows_here = x.shape[0] // int(np.prod([mesh.shape[i] for i, pl in enumerate(x_pl)
                                           if pl.is_shard()]))
    if (rows_here * x.shape[1]) % g:  # a rank's rows would split a group: route them all
        x_pl = [Replicate()] * len(names)
    back = x.placements
    x = x.redistribute(mesh, x_pl) if tuple(x.placements) != tuple(x_pl) else x
    first = mesh.get_local_rank("model") * (cfg.n_experts // m) if by_model else 0
    rows = {i for i, pl in enumerate(x_pl) if pl.is_shard()}  # the batch's mesh dims
    experts = {names.index("model")} if by_model else set()
    parts = int(np.prod([mesh.shape[i] for i in rows | experts]))

    def local(xl, rl, wil, wol):
        xl, rl, wil, wol = _contiguous_grads(xl, rl, wil, wol)
        out, aux = _experts(cfg, rl, wil, wol, xl, g, first)
        # each rank's share of the mean over every group, once over the
        # ranks that split the experts
        return out, aux / parts

    everywhere = rows | experts
    out_pl = [Partial() if i in experts else pl for i, pl in enumerate(x_pl)]
    aux_pl = [Partial() if i in everywhere else Replicate() for i in range(len(names))]
    out, aux = local_map(
        local, out_placements=(out_pl, aux_pl),
        in_placements=(tuple(x_pl), router.placements, w_in.placements, w_out.placements),
        in_grad_placements=(_partial_where_split(x_pl, experts),
                            _partial_where_split(router.placements, everywhere),
                            _partial_where_split(weight_pl, rows),
                            _partial_where_split(weight_pl, rows)),
        device_mesh=mesh)(x, router, w_in, w_out)
    out = out.redistribute(mesh, x_pl).to(x.dtype)  # the f32 sum, then one rounding
    if tuple(x_pl) != tuple(back):
        x, out = (t.redistribute(mesh, back) for t in (x, out))
    aux = aux.redistribute(mesh, [Replicate()] * len(names))
    return _shared(cfg, p, x, out), aux


def _experts(cfg: ModelConfig, router, w_in, w_out, x, g: int, first: int = 0):
    """Route x (B, S, D) in groups of ``g`` tokens and run the experts
    ``first .. first + len(w_in)`` (all of them by default): (out (B, S, D)
    f32, the sum of the kept choices of those experts times their gates,
    and the load-balance loss of these tokens' groups)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    G = T // g
    assert G * g == T, f"tokens {T} not divisible by group {g}"
    xt = x.reshape(G, g, D)
    probs, idx, gate, within = route(cfg, router, xt)
    C = _capacity(g, cfg)
    El = w_in.shape[0]
    keep = within < C
    if El < E:  # this rank's experts only
        keep = keep & (idx >= first) & (idx < first + El)
        idx_l = (idx - first).clamp(0, El - 1)
    else:
        idx_l = idx

    # slot of each (token, choice) in the (E, G, C) expert buffer; every
    # dropped choice goes to one spare row past its end (no host sync to
    # count the kept ones)
    group = torch.arange(G, device=x.device)[:, None, None]
    slot = ((idx_l * G + group) * C + within.clamp(max=C - 1)).reshape(-1)
    kept = keep.reshape(-1)
    spare = El * G * C
    expert_in = torch.zeros((spare + 1, D), dtype=mp(x).dtype, device=x.device)
    expert_in.index_copy_(0, torch.where(kept, slot, spare),
                          mp(x).reshape(T, D).repeat_interleave(K, dim=0))
    f = w_out.shape[1]
    h = torch.bmm(expert_in[:spare].reshape(El, G * C, D), mp(w_in))
    h = F.silu(h[..., :f].float()).to(h.dtype) * h[..., f:]
    expert_out = torch.bmm(h, mp(w_out)).reshape(El * G * C, D)
    # a dropped choice points at slot C - 1 of its expert; it adds 0
    picked = expert_out[slot].float().reshape(T, K, D)
    picked = torch.where(kept.reshape(T, K, 1), picked, 0.0)
    out = (gate.reshape(T, K, 1) * picked).sum(dim=1).reshape(B, S, D)

    # load-balance aux loss
    frac = F.one_hot(idx, E).sum(dim=2).float().mean(dim=1)  # (G, E) dispatch fraction
    pmean = probs.mean(dim=1)  # (G, E)
    aux = E * (frac * pmean).sum(dim=-1).mean()
    return out, aux
