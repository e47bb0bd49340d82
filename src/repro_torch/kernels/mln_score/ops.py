"""Batched MLN set scoring ``f(x) = x . u + 1/2 x^T C x``: CUDA kernel and plain version.

The Type-II score of the MLN matcher, per (neighborhood, candidate set):

    ``score_sets(u, C, X)``: u (B, P), C (B, P, P) symmetric, X (B, S, P) -> (B, S) f32.

Kernel: ``csrc/mln_score.cu`` (replaces the Pallas kernel
``src/repro/kernels/mln_score/kernel.py``); the source says what bounds
it on the H100.  CPU tensors go to :func:`score_sets_plain`.

The kernel reads only the rows ``C[b, q, :]`` whose ``x_q`` is nonzero
(``0.0`` and ``-0.0`` are skipped).  That is exact whenever ``C`` is
finite, since a skipped row adds exactly ``0 * (C[q] . x) = 0``; the
grounding's ``C = w_co * link`` always is.  Where a skipped row of ``C``
holds an inf or a NaN the plain version gives NaN (``0 * inf``) and the
kernel does not.  X may hold any float32 values, not only 0/1.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, takes_plain


def score_sets_plain(u, C, X):
    """Plain PyTorch version: u (B,P), C (B,P,P), X (B,S,P) -> (B,S) f32."""
    u, C, X = u.float(), C.float(), X.float()
    lin = torch.einsum("bsp,bp->bs", X, u)
    quad = 0.5 * torch.einsum("bsp,bpq,bsq->bs", X, C, X)
    return lin + quad


def score_sets(u, C, X):
    """u (B, P), C (B, P, P), X (B, S, P) -> (B, S) unnormalized log P."""
    if takes_plain(X):
        return score_sets_plain(u, C, X)
    B, S, P = X.shape
    check_operand("u", u, (B, P), X.device)
    check_operand("C", C, (B, P, P), X.device)
    check_operand("X", X, (B, S, P), X.device)
    out = torch.empty((B, S), dtype=torch.float32, device=X.device)
    rc = build.library().repro_mln_score(
        u.data_ptr(), C.data_ptr(), X.data_ptr(), out.data_ptr(), B, S, P,
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    build.check("mln_score", rc)
    score_sets.launches += 1
    return out


score_sets.launches = 0
