"""Blocked n-gram cosine similarity with fused threshold: CUDA kernel and plain version.

The canopy construction's seed-vs-pool probe over L2-normalized hashed
n-gram profiles:

    ``sim_above(A, B, t)``: A (M, F), B (N, F) -> (M, N) f32, entries < t zeroed.
    ``sim_matrix(A, B)``:   the same with t = -2 (every cosine kept).

Kernel: ``csrc/ngram_sim.cu`` (replaces the Pallas kernel
``src/repro/kernels/ngram_sim/kernel.py``); the source says what bounds
it on the H100.  CPU tensors go to :func:`sim_above_plain`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, takes_plain


def sim_above_plain(A, B, threshold: float):
    """Plain PyTorch version: A (M,F), B (N,F) -> (M,N), entries < threshold zeroed."""
    s = torch.matmul(A.float(), B.float().T)
    return torch.where(s >= threshold, s, torch.zeros_like(s))


def sim_above(A, B, threshold: float):
    """A (M, F), B (N, F) -> (M, N) f32, entries < ``threshold`` zeroed."""
    if takes_plain(A):
        return sim_above_plain(A, B, threshold)
    (M, F), N = A.shape, B.shape[0]
    check_operand("A", A, (M, F), A.device)
    check_operand("B", B, (N, F), A.device)
    out = torch.empty((M, N), dtype=torch.float32, device=A.device)
    rc = build.library().repro_ngram_sim(
        A.data_ptr(), B.data_ptr(), out.data_ptr(), M, N, F, float(threshold),
        torch.cuda.current_stream(A.device).cuda_stream,
    )
    build.check("ngram_sim", rc)
    sim_above.launches += 1
    return out


sim_above.launches = 0


def sim_matrix(A, B):
    return sim_above(A, B, -2.0)
