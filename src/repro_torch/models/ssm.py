"""Mamba-1 selective SSM block (the Falcon-Mamba mixer).

The selective recurrence

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t
    y_t = C_t . h_t + D * x_t

is a first-order linear recurrence in f32.  ``ssm_forward`` runs it in
chunks of ``chunk`` tokens, carrying the (B, d_inner, N) state from one
chunk to the next; within a chunk a Hillis-Steele scan combines the
(decay, input) pairs in log2(chunk) steps, the same associative
operator as the reference's ``associative_scan``.  The last chunk may be
shorter than the others.  Only one chunk's (B, chunk, d_inner, N)
tensors are live at a time.  Under autograd each chunk is checkpointed
(``torch.utils.checkpoint``, non-reentrant): the graph keeps the chunk's
inputs and its carried state, and the backward recomputes the chunk's
scan, the same operations on the same inputs, so no number changes.
Without it the scan's log2(chunk) doubling steps each keep two
(B, chunk, d_inner, N) f32 tensors for the backward: by their sizes about
62 GiB a layer for Falcon-Mamba-7B at 4 x 2,048 tokens, against one
chunk's 4 GiB recomputed at a time.

Decode carries (conv window, SSM state): O(1) a token.  The reference
has no Pallas kernel here; a selective-scan kernel would be new work.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    _contiguous_grads, _is_dtensor, mp, row_project, shard_spec,
)
from repro_torch.models.param import PSpec, in_bf16


def ssm_specs(cfg: ModelConfig) -> dict:
    d, di, n, r, c = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    return {
        **in_bf16({
            "in_proj": PSpec((d, 2 * di), ("data", "model")),
            "conv_w": PSpec((di, c), ("model", None), scale=0.5),
            "conv_b": PSpec((di,), ("model",), init="zeros"),
            "x_proj": PSpec((di, r + 2 * n), ("model", None)),
            "dt_proj": PSpec((r, di), (None, "model")),
            "dt_bias": PSpec((di,), ("model",), init="ssm_dt"),
            "out_proj": PSpec((di, d), ("model", "data")),
        }),
        "A_log": PSpec((di, n), ("model", None), init="ssm_a"),
        "D": PSpec((di,), ("model",), init="ones"),
    }


def _conv_window(window, p):
    """The depthwise conv's output at the window's last position: window
    (B, ..., width, Di) -> (B, ..., Di), summed in f32 and rounded once."""
    taps = mp(p["conv_w"]).float().T  # (width, Di)
    return mp((window.float() * taps).sum(dim=-2)) + mp(p["conv_b"])


def _causal_conv(p, x):
    """Depthwise causal conv along S. x (B, S, Di)."""
    width = p["conv_w"].shape[1]
    S = x.shape[1]
    xp = F.pad(mp(x), (0, 0, width - 1, 0))  # (B, S + width - 1, Di)
    window = torch.stack([xp[:, j:j + S] for j in range(width)], dim=2)  # (B, S, width, Di)
    return _conv_window(window, p)


def _ssm_params(cfg: ModelConfig, p, u):
    """u (B, S, Di) conv output -> dt (B,S,Di), Bm/Cm (B,S,N), A (Di,N)."""
    n, r = cfg.ssm_state, cfg.dt_rank
    proj = torch.matmul(u, mp(p["x_proj"]))
    dt_r, Bm, Cm = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    dt = torch.matmul(dt_r, mp(p["dt_proj"])) + mp(p["dt_bias"])
    dt = F.softplus(dt.float())  # (B,S,Di) f32
    A = -torch.exp(p["A_log"].float())  # (Di, N)
    return dt, Bm.float(), Cm.float(), A


def _chunk_scan(dt, Bm, Cm, A, u, h0):
    """The recurrence over one chunk: dt (B,c,Di) | Bm, Cm (B,c,N) | A (Di,N)
    | u (B,c,Di) | h0 (B,Di,N) carried state.  Returns (y (B,c,Di) f32,
    the state after the chunk)."""
    decay = torch.exp(dt[..., None] * A)  # (B,c,Di,N)
    inp = (dt * u.float())[..., None] * Bm[:, :, None, :]  # (B,c,Di,N)
    inp[:, 0] += decay[:, 0] * h0  # fold the carried state into the first step
    c = decay.shape[1]
    shift = 1
    while shift < c:  # inclusive scan of (a, b) o (a', b') = (a a', a' b + b')
        inp = torch.cat([inp[:, :shift], decay[:, shift:] * inp[:, :-shift] + inp[:, shift:]], 1)
        decay = torch.cat([decay[:, :shift], decay[:, shift:] * decay[:, :-shift]], 1)
        shift *= 2
    y = torch.einsum("bsdn,bsn->bsd", inp, Cm)
    return y, inp[:, -1].clone()  # not a view: it would hold the chunk's whole inp


def _scan(dt, Bm, Cm, A, u, chunk: int):
    """The selective scan over the whole sequence, chunk by chunk from a
    zero state: y (B, S, Di) f32.  Under autograd each chunk is a
    checkpoint (the module's docstring)."""
    B, S, di = u.shape
    h = torch.zeros((B, di, A.shape[-1]), dtype=torch.float32, device=u.device)
    step = _chunk_scan
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dt, Bm, Cm, A, u)):
        step = functools.partial(checkpoint, _chunk_scan, use_reentrant=False,
                                 preserve_rng_state=False)  # the scan draws nothing
    ys = []
    for lo in range(0, S, chunk):
        sl = slice(lo, min(lo + chunk, S))
        y, h = step(dt[:, sl], Bm[:, sl], Cm[:, sl], A, u[:, sl], h)
        ys.append(y)
    return torch.cat(ys, dim=1)


def _scan_sharded(dt, Bm, Cm, A, u, chunk: int):
    """:func:`_scan` of DTensors on each rank's rows and channels
    (``local_map``): the recurrence is elementwise over the batch and the
    channels, so each rank's block is the whole scan of its block, the
    same numbers.  ``Bm``/``Cm`` are laid out with ``u``'s rows and every
    channel; ``A`` with ``u``'s channels."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = u.device_mesh
    u_pl = [p if p.is_shard() and p.dim in (0, 2) else Replicate() for p in u.placements]
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in u_pl]
    chans = [Shard(0) if p.is_shard(2) else Replicate() for p in u_pl]
    dt, u = (t.redistribute(mesh, u_pl) for t in (dt, u))
    Bm, Cm = (t.redistribute(mesh, rows) for t in (Bm, Cm))
    A = A.redistribute(mesh, chans)
    # a rank's channels read all of Bm/Cm, and its rows all of A
    bc_grad = [Partial() if p.is_shard(2) else r for p, r in zip(u_pl, rows)]
    a_grad = [Partial() if p.is_shard(0) else c for p, c in zip(u_pl, chans)]
    return local_map(
        lambda d, b, c, a, x: _scan(*_contiguous_grads(d, b, c, a, x), chunk),
        out_placements=u_pl, in_placements=(u_pl, rows, rows, chans, u_pl),
        in_grad_placements=(u_pl, bc_grad, bc_grad, a_grad, u_pl), device_mesh=mesh,
    )(dt, Bm, Cm, A, u)


def ssm_forward(cfg: ModelConfig, p, x, *, chunk: int = 128):
    """Full-sequence selective SSM. x (B, S, D) bf16 -> (B, S, D)."""
    B, S, _ = x.shape
    di = cfg.d_inner
    xz = torch.matmul(x, mp(p["in_proj"]))
    xs, z = xz[..., :di], xz[..., di:]
    u = F.silu(_causal_conv(p, xs).float()).to(x.dtype)
    # re-pin (B, S, Di) to (dp, None, model), or the f32 dt/u tensors replicate
    u = shard_spec(u, ("dp", None, "model"))
    dt, Bm, Cm, A = _ssm_params(cfg, p, u)
    dt = shard_spec(dt, ("dp", None, "model"))
    y = _scan(dt, Bm, Cm, A, u, chunk) if not _is_dtensor(u) else _scan_sharded(
        dt, Bm, Cm, A, u, chunk)
    y = y + u.float() * p["D"].float()
    y = y * F.silu(z.float())
    return row_project(y.to(x.dtype), p["out_proj"])


def ssm_cache_specs(cfg: ModelConfig, batch: int) -> dict:
    di, n, c = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    b_ax = "data" if batch > 1 else None
    return {
        "conv": PSpec((batch, c - 1, di), (b_ax, None, "model"), init="zeros",
                      dtype=torch.bfloat16),
        "h": PSpec((batch, di, n), (b_ax, "model", None), init="zeros", dtype=torch.float32),
    }


def ssm_decode(cfg: ModelConfig, p, x, cache):
    """Single-token step. x (B,1,D); cache {conv (B,c-1,Di), h (B,Di,N)},
    updated in place (the returned cache is the given one)."""
    di = cfg.d_inner
    xz = torch.matmul(x, mp(p["in_proj"]))
    xs, z = xz[..., :di], xz[..., di:]  # (B,1,Di)
    window = torch.cat([cache["conv"].to(xs.dtype), xs], dim=1)  # (B,c,Di)
    u = F.silu(_conv_window(window, p).float()).to(x.dtype)[:, None, :]  # (B,1,Di)
    dt, Bm, Cm, A = _ssm_params(cfg, p, u)
    decay = torch.exp(dt[:, 0, :, None] * A)  # (B,Di,N)
    inp = (dt[:, 0] * u[:, 0].float())[..., None] * Bm[:, 0, None, :]
    h = decay * cache["h"] + inp
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])
    y = y + u[:, 0].float() * p["D"].float()
    y = y * F.silu(z[:, 0].float())
    out = row_project(y.to(x.dtype), p["out_proj"])[:, None, :]
    cache["conv"].copy_(window[:, 1:])
    cache["h"].copy_(h)
    return out, cache
