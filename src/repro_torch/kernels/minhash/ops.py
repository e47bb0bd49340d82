"""Batched MinHash signatures for the streaming LSH index: CUDA kernel and plain version.

    ``minhash(X, A)``: X (N, D) f32 presence (nonzero = shingle present),
    A (H, D) int32 hash table -> (N, H) int32 signatures; a row with no
    present shingle gets the ``EMPTY`` sentinel.
    ``minhash_transposed(X, At)``: the same from the table stored
    transposed, At (D, H) = A.T contiguous, where a present shingle is one
    row (the streaming index keeps its table so).
    ``hash_table(H, D, seed)``: (H, D) int32 numpy table in ``[0, EMPTY)``,
    the reference's numpy draw byte for byte.

Kernel: ``csrc/minhash.cu`` (replaces the Pallas kernel
``src/repro/kernels/minhash/kernel.py``); the source says what bounds
it on the H100.  CPU tensors go to :func:`minhash_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, takes_plain

# Hash values live in [0, EMPTY); EMPTY marks "no shingle present".
EMPTY = 2**30

# rows of X per step of the plain version: its (rows, H, D) int32
# intermediate stays at 134 MB for H = 128, D = 512
_PLAIN_ROWS = 512


def minhash_plain(X, A):
    """Plain PyTorch version: X (N, D) presence, A (H, D) int32 -> (N, H) int32."""
    A = A.to(torch.int32)
    chunks = [
        torch.where(X[lo : lo + _PLAIN_ROWS, None, :] > 0, A[None], EMPTY).amin(-1)
        for lo in range(0, X.shape[0], _PLAIN_ROWS)
    ]
    if not chunks:
        return torch.empty((0, A.shape[0]), dtype=torch.int32, device=A.device)
    return torch.cat(chunks).to(torch.int32)


def _launch(X, A, H: int, stride_h: int, stride_d: int):
    N, D = X.shape
    out = torch.empty((N, H), dtype=torch.int32, device=X.device)
    if N == 0:
        return out
    rc = build.library().repro_minhash(
        X.data_ptr(), A.data_ptr(), out.data_ptr(), N, H, D, stride_h, stride_d,
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    build.check("minhash", rc)
    minhash.launches += 1
    return out


def minhash(X, A):
    """X (N, D) f32 presence, A (H, D) int32 -> (N, H) int32 signatures."""
    if takes_plain(X):
        return minhash_plain(X, A)
    (N, D), H = X.shape, A.shape[0]
    check_operand("X", X, (N, D), X.device)
    check_operand("A", A, (H, D), X.device, dtype=torch.int32)
    return _launch(X, A, H, D, 1)


def minhash_transposed(X, At):
    """``minhash(X, At.T)`` from the transposed table At (D, H) int32."""
    if takes_plain(X):
        return minhash_plain(X, At.T)
    (N, D), H = X.shape, At.shape[1]
    check_operand("X", X, (N, D), X.device)
    check_operand("At", At, (D, H), X.device, dtype=torch.int32)
    return _launch(X, At, H, 1, H)


minhash.launches = 0  # both entries launch the one kernel


def hash_table(num_hashes: int, dim: int, seed: int = 0) -> np.ndarray:
    """(H, D) int32 table of independent random hash values in [0, EMPTY).

    One tabulated draw of ``num_hashes`` random orderings of the shingle
    vocabulary; collisions across slots are harmless (MinHash only needs
    the argmin distribution to be uniform-ish).
    """
    rng = np.random.default_rng(seed)
    return rng.integers(0, int(EMPTY), size=(num_hashes, dim), dtype=np.int32)
