"""Transitive closure of a match set (paper Appendix A).

The transitivity rule itself is not monotone, but "the transitive
closure of any monotonic matcher is monotonic" — the paper supports
transitivity by closing the match set after message passing terminates
(or at the end of each iteration).  We implement the host-side closure
(union-find over entity ids) plus cluster extraction used by the
evaluation metrics.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import pairs as pairlib, txn
from repro_torch.core.types import MatchStore


class UnionFind:
    """Union-find with path compression.

    Every ``parent``/``rank`` entry write is journaled into the active
    ingest transaction (including the compression writes inside
    ``find`` — an undo log that only covered ``union`` links would
    restore a parent chain that later ``find``s had already
    compressed *through* the rolled-back link)."""

    def __init__(self):
        self.parent: dict[int, int] = {}
        self.rank: dict[int, int] = {}

    def find(self, x: int) -> int:
        t = txn.active()
        if x not in self.parent:
            if t is not None:
                t.save_key(self.parent, x)
                t.save_key(self.rank, x)
            self.parent[x] = x
            self.rank[x] = 0
        p = self.parent[x]
        while p != self.parent[p]:
            if t is not None:
                t.save_key(self.parent, p)
            self.parent[p] = self.parent[self.parent[p]]
            p = self.parent[p]
        if t is not None:
            t.save_key(self.parent, x)
        self.parent[x] = p
        return p

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        t = txn.active()
        if t is not None:
            t.save_key(self.parent, rb)
            t.save_key(self.rank, ra)
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1

    def clusters(self) -> list[np.ndarray]:
        by_root: dict[int, list[int]] = {}
        for x in list(self.parent.keys()):
            by_root.setdefault(self.find(x), []).append(x)
        return [np.asarray(sorted(v), dtype=np.int64) for v in by_root.values()]


def clusters_of(store: MatchStore) -> list[np.ndarray]:
    """Connected components of the match graph (entity-id clusters)."""
    uf = UnionFind()
    a, b = pairlib.split_gid(store.gids)
    for x, y in zip(a.tolist(), b.tolist()):
        uf.union(int(x), int(y))
    return [c for c in uf.clusters() if len(c) >= 2]


def transitive_closure(store: MatchStore) -> MatchStore:
    """All intra-cluster pairs of the match graph's components."""
    gids: list[np.ndarray] = [store.gids]
    for c in clusters_of(store):
        n = len(c)
        if n <= 2:
            continue
        ii, jj = np.triu_indices(n, k=1)
        gids.append(pairlib.make_gid(c[ii], c[jj]))
    if len(gids) == 1:
        return store
    return MatchStore(np.concatenate(gids))
