"""Canonical pair indexing for neighborhood candidate pairs.

A neighborhood holds up to ``k`` entities (padded).  Candidate match
variables live on the upper triangle of the ``k x k`` entity grid:
``P = k * (k - 1) // 2`` slots.  This module provides the static
index maps between pair-slot ``p`` and entity slots ``(i, j), i < j``,
plus global pair ids used to exchange matches across neighborhoods.

Global pair id convention: for global entity ids ``a < b``,
``gid = a * GID_STRIDE + b`` stored as int64.  ``GID_STRIDE`` must
exceed the number of entities in the universe.
"""

from __future__ import annotations

import functools

import numpy as np

GID_STRIDE = np.int64(1) << np.int64(32)


@functools.lru_cache(maxsize=None)
def triu_indices(k: int) -> tuple[np.ndarray, np.ndarray]:
    """Static (ii, jj) arrays, each of shape (P,), with ii[p] < jj[p]."""
    ii, jj = np.triu_indices(k, k=1)
    return ii.astype(np.int32), jj.astype(np.int32)


@functools.lru_cache(maxsize=None)
def pair_slot_table(k: int) -> np.ndarray:
    """(k, k) table mapping entity-slot pairs to pair slot (or -1)."""
    ii, jj = triu_indices(k)
    tab = np.full((k, k), -1, dtype=np.int32)
    p = np.arange(len(ii), dtype=np.int32)
    tab[ii, jj] = p
    tab[jj, ii] = p
    return tab


def num_pairs(k: int) -> int:
    return k * (k - 1) // 2


def make_gid(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Global pair id for global entity ids a, b (any order)."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    return lo * GID_STRIDE + hi


def split_gid(gid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    gid = np.asarray(gid, dtype=np.int64)
    return gid // GID_STRIDE, gid % GID_STRIDE
