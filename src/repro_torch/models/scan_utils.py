"""The layer loop with grouped activation checkpointing.

``stacked_scan(body, x, layers, group, *args)`` runs ``body(layer, x,
*args) -> (x, aux)`` over the layers in order and sums the ``aux``
outputs (e.g. MoE load-balance losses).  With grad mode on, the loop is
checkpointed (``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``), so the backward pass recomputes what it needs:

* ``group <= 1``, or L not divisible by ``group``: one checkpoint per
  layer; every layer input is saved (L x (B, S, D) residuals).
* ``group g > 1``: one checkpoint per group of g consecutive layers; only
  the L/g group inputs are saved, and each group's interior is recomputed
  in the backward (L/g + g transient instead of L: the O(sqrt L) schedule
  at g ~ sqrt(L)).  Each layer's forward runs twice a step: once forward,
  once recomputed.

Without grad mode it is a plain loop.  The recompute repeats the same
operations on the same inputs, so remat changes no number.  The
reference's ``optimization_barrier`` on each checkpoint's input pins
XLA's memory layout; eager PyTorch saves exactly the checkpoint's
inputs, so it has no counterpart here.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _run(body, layers, x, *args):
    auxs = []
    for lp in layers:
        x, a = body(lp, x, *args)
        auxs.append(a)
    return x, torch.stack(auxs)


def stacked_scan(body, x, layers, group: int = 0, *args):
    """body(layer, x, *args) -> (x, aux). Returns (x, aux summed over the
    layers in order, the same sum for every ``group``)."""
    layers = list(layers)
    if torch.is_grad_enabled():
        L = len(layers)
        g = group if group and group > 1 and L % group == 0 else 1
        parts = []
        for i in range(0, L, g):
            x, a = checkpoint(_run, body, layers[i:i + g], x, *args, use_reentrant=False)
            parts.append(a)
        auxs = torch.cat(parts)
    else:
        x, auxs = _run(body, layers, x, *args)
    total = torch.zeros((), device=x.device)
    for a in auxs:
        total = total + a
    return x, total
