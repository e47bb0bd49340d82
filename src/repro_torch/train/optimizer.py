"""AdamW + cosine schedule + global-norm clipping, the reference's step by step.

Parameters, gradients and the moments are trees: nested dicts of tensors
(a model's ``named_parameters()`` as one flat dict is such a tree).  The
moments ``m`` and ``v`` are f32 and keyed like the parameters.  The
update is written out as the reference writes it, not with
``torch.optim.AdamW``, which decays before the moment update and orders
its operations otherwise: the same numbers need the same operations.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts recursed)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    """The leaves in sorted-key order (JAX's flattening order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def schedule(cfg: OptConfig, step):
    """The learning rate at ``step`` (an int tensor), in f32: linear warmup,
    then a cosine from ``lr`` down to ``min_lr_ratio * lr``."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(torch.tensor(math.pi, dtype=torch.float32) * t))
    decayed = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decayed


def init_opt_state(params) -> dict:
    """Zero f32 moments keyed like ``params``, and ``step`` 0 (int32)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = _leaves(params)[0].device
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    total = None
    for x in _leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """``grads`` scaled to a global norm of at most ``max_norm``, and that
    norm (``norm`` when the caller computed it: a sharded tree's)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return _map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, state, norm=None):
    """One AdamW step. Returns (new_params, new_state, metrics); the new
    parameters keep each parameter's dtype.  ``norm``: the gradients'
    global norm, where the leaves are shards of a larger tree."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), step.float())
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), step.float())

    def upd(p, g, m, v):
        m2 = cfg.b1 * m + (1.0 - cfg.b1) * g
        v2 = cfg.b2 * v + (1.0 - cfg.b2) * g * g
        mhat = m2 / b1c
        vhat = v2 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p2 = p.float() - lr * delta
        return p2.to(p.dtype), m2, v2

    out = _map(lambda *a: upd(*a), params, grads, state["m"], state["v"])
    return (
        _map(lambda o: o[0], out),
        {"m": _map(lambda o: o[1], out), "v": _map(lambda o: o[2], out), "step": step},
        {"grad_norm": gnorm, "lr": lr},
    )
