"""Cross-pod gradient compression: int8 quantization with error feedback.

Inside one pod, gradients reduce at full precision.  *Across* pods the
links are slow, so each gradient leaf is quantized to symmetric int8 with
one scale shared by the pods (the largest |g| over them), summed, and
dequantized; an *error-feedback* residual carries each pod's quantization
error into its next step (Seide et al. / EF-SGD: convergence stays
unbiased to first order).

The operations are the reference's, in its order: ``g + err``, the scale
``max(amax, 1e-12) / 127``, round half to even, clip to ±127, the
residual ``g - q * scale``, and ``total * scale / n``.  Integer sums are
exact in any order, so the result is the reference's bit for bit.  The
residual is rounded once, as the reference's compiler fuses it into one
multiply-subtract: here ``q * scale`` and the difference are computed in
f64, where both are exact, and rounded to f32 at the end, on any device.

**Bytes.**  The sum runs in int32, as the reference's ``psum`` does: a
rank sends and receives the int32 all-reduce of every element, 4 bytes
an element, as many as an f32 all-reduce, plus one f32 scale a leaf for
the max.  The int8 values would cut that to 1 byte an element only
through an int8 exchange (an all-gather of n ranks' int8 values, summed
locally in int32), which neither package does yet.

``group`` is a ``torch.distributed`` process group (the ``pod`` group of
the training mesh, ``DeviceMesh.get_group("pod")``); its collectives run
on the tensors' own device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def quantize(g: torch.Tensor, group=None):
    """Symmetric int8 quantization of ``g``: ``(q, scale)``.  The scale is
    the largest |g| over ``group`` (an all-reduce MAX, so every rank
    shares it and the int32 sum is exact); ``group=None``: the local scale
    (one rank, tests)."""
    amax = torch.amax(torch.abs(g))
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(g: torch.Tensor, group, err: torch.Tensor):
    """Error-feedback int8 sum of ``g`` over ``group``: (the mean over the
    ranks, the new residual).  ``g``, ``err``: this rank's gradient and
    carried residual, f32 after the cast."""
    g = g.float() + err
    q, scale = quantize(g, group)
    new_err = (g.double() - q.double() * scale.double()).float()
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    n = float(dist.get_world_size(group))
    return total.float() * scale / n, new_err


def tree_compressed_psum(grads: dict, group, err_tree: dict):
    """:func:`compressed_psum` over every leaf of a nested dict (leaves in
    sorted-key order), with ``err_tree`` of the same structure: (the
    reduced tree, the new residual tree)."""
    if not isinstance(grads, dict):
        return compressed_psum(grads, group, err_tree)
    out, new_err = {}, {}
    for k in sorted(grads):
        out[k], new_err[k] = tree_compressed_psum(grads[k], group, err_tree[k])
    return out, new_err


def init_error_state(params: dict, device=None) -> dict:
    """Zero f32 residuals shaped like ``params`` (a nested dict of tensors),
    on ``device`` (default: each leaf's own)."""
    if not isinstance(params, dict):
        return torch.zeros(params.shape, dtype=torch.float32, device=device or params.device)
    return {k: init_error_state(v, device) for k, v in params.items()}
