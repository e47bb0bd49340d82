"""ICM conditional-delta sweep ``delta = u + X @ C``: CUDA kernel and plain version.

The inner step of the MLN matcher's closure (S = 1) and of its
entailment matrix (S = P).  One batched function carries all three of
the reference's entry points:

    ``sweep_batched(u, C, X)``: u (B, P), C (B, P, P), X (B, S, P) -> (B, S, P)
    ``sweep_matrix(u, C, X)``:  u (P,), C (P, P), X (S, P) -> (S, P)
    ``sweep(u, C, x)``:         x (P,) -> (P,)
    ``sweep_batch(u, C, X)``:   u (B, P), C (B, P, P), X (B, P) -> (B, P)

Kernel: ``csrc/icm_sweep.cu`` (replaces the Pallas kernel
``src/repro/kernels/icm_sweep/kernel.py``); the source says what bounds
it on the H100.  CPU tensors go to :func:`sweep_batched_plain`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, takes_plain


def sweep_batched_plain(u, C, X):
    """Plain PyTorch version: u (B,P), C (B,P,P), X (B,S,P) -> (B,S,P) f32."""
    return u.float()[:, None, :] + torch.matmul(X.float(), C.float())


def sweep_batched(u, C, X):
    """u (B, P), C (B, P, P), X (B, S, P) -> (B, S, P) f32."""
    if takes_plain(X):
        return sweep_batched_plain(u, C, X)
    B, S, P = X.shape
    check_operand("u", u, (B, P), X.device)
    check_operand("C", C, (B, P, P), X.device)
    check_operand("X", X, (B, S, P), X.device)
    out = torch.empty((B, S, P), dtype=torch.float32, device=X.device)
    rc = build.library().repro_icm_sweep(
        u.data_ptr(), C.data_ptr(), X.data_ptr(), out.data_ptr(), B, S, P,
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    build.check("icm_sweep", rc)
    sweep_batched.launches += 1
    sweep_batched.rows += B
    return out


sweep_batched.launches = 0
sweep_batched.rows = 0  # the batch rows B, summed over the launches


def sweep_matrix(u, C, X):
    """u (P,), C (P, P), X (S, P) -> (S, P) f32."""
    return sweep_batched(u[None], C[None], X[None])[0]


def sweep(u, C, x):
    """u (P,), C (P, P), x (P,) -> (P,) f32."""
    return sweep_batched(u[None], C[None], x[None, None])[0, 0]


def sweep_batch(u, C, X):
    """u (B, P), C (B, P, P), X (B, P) -> (B, P) f32: one sweep per neighborhood."""
    return sweep_batched(u, C, X[:, None, :])[:, 0]
