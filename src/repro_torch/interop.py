"""Carry state across from numpy: MLN weights, packed covers, groundings.

Every function reads its source's attributes by name and copies them as
numpy arrays, so state made by any producer with the same field names —
the JAX reference included — becomes the port's own objects without
importing that producer.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.cover import Cover, PackedCover
from repro_torch.core.global_grounding import GlobalGrounding
from repro_torch.core.mln import MLNWeights
from repro_torch.core.types import NeighborhoodBatch

BATCH_FIELDS = (
    "entity_ids", "entity_mask", "coauthor", "sim_level", "pair_gid", "pair_mask",
)


def weights_from_numpy(w_sim, w_co) -> MLNWeights:
    """MLN weights from a length-4 ``w_sim`` and a scalar ``w_co``."""
    w = np.asarray(w_sim, dtype=np.float64).reshape(-1)
    if w.shape != (4,):
        raise ValueError(f"w_sim needs 4 levels, got shape {w.shape}")
    return MLNWeights(w_sim=tuple(float(v) for v in w), w_co=float(w_co))


def batch_from_arrays(src) -> NeighborhoodBatch:
    """A :class:`NeighborhoodBatch` from the six fields of ``src``."""
    return NeighborhoodBatch(*(np.array(getattr(src, f)) for f in BATCH_FIELDS))


def packed_from_arrays(src) -> PackedCover:
    """A :class:`PackedCover` from ``bins``, ``bin_rows``, ``neighborhood_bin``,
    ``neighborhood_row``, ``pair_levels`` and ``cover`` (``core``/``full``)."""
    cover = src.cover
    return PackedCover(
        bins={int(k): batch_from_arrays(b) for k, b in src.bins.items()},
        bin_rows={int(k): np.array(v) for k, v in src.bin_rows.items()},
        neighborhood_bin=np.array(src.neighborhood_bin),
        neighborhood_row=np.array(src.neighborhood_row),
        pair_levels={int(g): int(lv) for g, lv in src.pair_levels.items()},
        cover=Cover(
            core=[np.array(c) for c in cover.core],
            full=[np.array(f) for f in cover.full],
        ),
    )


def grounding_from_arrays(src) -> GlobalGrounding:
    """A :class:`GlobalGrounding` from ``gids``, ``u``, ``coup_p``, ``coup_q``, ``w_co``."""
    return GlobalGrounding(
        gids=np.array(src.gids, dtype=np.int64),
        u=np.array(src.u, dtype=np.float32),
        coup_p=np.array(src.coup_p, dtype=np.int32),
        coup_q=np.array(src.coup_q, dtype=np.int32),
        w_co=float(src.w_co),
    )
