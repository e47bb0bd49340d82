"""Core data types for the collective entity-matching framework.

Everything the device sees is a *padded dense tensor*; everything kept on
the host between message-passing rounds is a plain numpy structure.

The paper's objects map as follows:

=====================  =========================================
Paper                  Here
=====================  =========================================
entity set E           :class:`EntityTable`
relations R            :class:`Relations` (Coauthor adjacency COO)
neighborhood C_i       one row of :class:`NeighborhoodBatch`
cover C                :class:`NeighborhoodBatch` (+ bins)
match set M+           :class:`MatchStore` (sorted int64 gids)
maximal message        one row of a message table (host)
=====================  =========================================
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from repro_torch.core import pairs as pairlib


@dataclasses.dataclass
class EntityTable:
    """A set of entity references.

    names:     list of raw strings (author-reference surface forms).
    truth:     int64 ground-truth entity id per reference (-1 unknown).
    features:  optional hashed n-gram count profiles (N, F) float32,
               built lazily by repro_torch.core.similarity.ngram_profiles.
    """

    names: list[str]
    truth: np.ndarray | None = None
    features: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.names)


@dataclasses.dataclass
class Relations:
    """Relational evidence (the paper's R). COO edge list over entity ids.

    For the bibliographic domain there is a single ``Coauthor`` relation;
    the framework supports any number of symmetric binary relations, each
    identified by name.
    """

    edges: dict[str, np.ndarray]  # name -> (E, 2) int64 (undirected)

    def adjacency_sets(self, name: str) -> dict[int, set[int]]:
        adj: dict[int, set[int]] = {}
        e = self.edges.get(name)
        if e is None:
            return adj
        for a, b in e:
            adj.setdefault(int(a), set()).add(int(b))
            adj.setdefault(int(b), set()).add(int(a))
        return adj

    def all_edges(self) -> np.ndarray:
        if not self.edges:
            return np.zeros((0, 2), dtype=np.int64)
        return np.concatenate(list(self.edges.values()), axis=0)


@dataclasses.dataclass
class NeighborhoodBatch:
    """A batch of ``B`` neighborhoods padded to ``k`` entity slots.

    entity_ids : (B, k) int64, -1 padding.
    entity_mask: (B, k) bool.
    coauthor   : (B, k, k) bool   relation adjacency restricted to slots.
    sim_level  : (B, P) int8      0 = not a candidate pair, else level 1..3.
    pair_gid   : (B, P) int64     global pair id (-1 where not a candidate).
    pair_mask  : (B, P) bool      candidate-pair validity.
    """

    entity_ids: np.ndarray
    entity_mask: np.ndarray
    coauthor: np.ndarray
    sim_level: np.ndarray
    pair_gid: np.ndarray
    pair_mask: np.ndarray

    @property
    def batch(self) -> int:
        return self.entity_ids.shape[0]

    @property
    def k(self) -> int:
        return self.entity_ids.shape[1]

    @property
    def num_pairs(self) -> int:
        return self.sim_level.shape[1]

    def row(self, b: int) -> "NeighborhoodBatch":
        return NeighborhoodBatch(
            self.entity_ids[b : b + 1],
            self.entity_mask[b : b + 1],
            self.coauthor[b : b + 1],
            self.sim_level[b : b + 1],
            self.pair_gid[b : b + 1],
            self.pair_mask[b : b + 1],
        )

    def select(self, idx: np.ndarray) -> "NeighborhoodBatch":
        return NeighborhoodBatch(
            self.entity_ids[idx],
            self.entity_mask[idx],
            self.coauthor[idx],
            self.sim_level[idx],
            self.pair_gid[idx],
            self.pair_mask[idx],
        )

    def pad_batch_to(self, n: int) -> "NeighborhoodBatch":
        """Pad the batch axis with empty neighborhoods (for SPMD shards)."""
        b = self.batch
        if b == n:
            return self
        assert n > b
        extra = n - b

        def _pad(x: np.ndarray, fill) -> np.ndarray:
            shape = (extra,) + x.shape[1:]
            return np.concatenate([x, np.full(shape, fill, dtype=x.dtype)])

        return NeighborhoodBatch(
            _pad(self.entity_ids, -1),
            _pad(self.entity_mask, False),
            _pad(self.coauthor, False),
            _pad(self.sim_level, 0),
            _pad(self.pair_gid, -1),
            _pad(self.pair_mask, False),
        )


class MatchStore:
    """Global set of matched pairs, kept as a sorted int64 gid array.

    Supports the three operations message passing needs: membership
    projection onto a neighborhood batch, union with new matches, and
    set difference (for "what is new this round").
    """

    def __init__(self, gids: np.ndarray | None = None):
        if gids is None:
            gids = np.zeros((0,), dtype=np.int64)
        self.gids = np.unique(np.asarray(gids, dtype=np.int64))

    def __len__(self) -> int:
        return int(self.gids.shape[0])

    def __contains__(self, gid: int) -> bool:
        i = np.searchsorted(self.gids, gid)
        return bool(i < len(self.gids) and self.gids[i] == gid)

    def copy(self) -> "MatchStore":
        return MatchStore(self.gids.copy())

    def union(self, new_gids: np.ndarray) -> "MatchStore":
        if len(new_gids) == 0:
            return self
        return MatchStore(np.concatenate([self.gids, new_gids]))

    def difference(self, other: "MatchStore") -> np.ndarray:
        return self.gids[~np.isin(self.gids, other.gids, assume_unique=True)]

    def mask_of(self, pair_gid: np.ndarray) -> np.ndarray:
        """Boolean mask of same shape as pair_gid: which pairs are in here."""
        if len(self.gids) == 0:
            return np.zeros(pair_gid.shape, dtype=bool)
        flat = pair_gid.reshape(-1)
        out = np.isin(flat, self.gids)
        out &= flat >= 0
        return out.reshape(pair_gid.shape)

    def as_set(self) -> set[int]:
        return set(int(g) for g in self.gids)

    @staticmethod
    def from_pairs(a: Iterable[int], b: Iterable[int]) -> "MatchStore":
        a = np.asarray(list(a), dtype=np.int64)
        b = np.asarray(list(b), dtype=np.int64)
        if len(a) == 0:
            return MatchStore()
        return MatchStore(pairlib.make_gid(a, b))
