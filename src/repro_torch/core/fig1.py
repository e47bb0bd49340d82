"""The paper's running example (Fig. 1 / Fig. 2 / §2.1-§2.2), as data.

Entities: author references a1,a2, b1,b2,b3, c1,c2,c3, d1.
Similar (level-1) pairs: all (ai,aj), (bi,bj), (ci,cj).
Coauthor edges: a1-b2, a2-b3, b1-c1, b2-c2, b3-c3, c1-d1, c2-d1.
Weights: R1 = -5, R2 = +8 (the §2.1 pedagogical MLN).

Expected behavior (verbatim from the paper):
  * full-run MLN:    {(c1,c2), (b1,b2), (a1,a2), (b2,b3), (c2,c3)}
  * NO-MP:           {(c1,c2)}                       (only C3 matches)
  * SMP:             + (b1,b2)                       (evidence message)
  * MMP:             everything, via maximal messages
                     {(a1,a2),(b2,b3)} + {(b2,b3),(c2,c3)} -> chain closed
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import pairs as pairlib
from repro_torch.core.cover import Cover, PackedCover
from repro_torch.core.types import EntityTable, MatchStore, NeighborhoodBatch, Relations

NAMES = ["a1", "a2", "b1", "b2", "b3", "c1", "c2", "c3", "d1"]
IDX = {n: i for i, n in enumerate(NAMES)}

SIMILAR = [
    ("a1", "a2"),
    ("b1", "b2"),
    ("b1", "b3"),
    ("b2", "b3"),
    ("c1", "c2"),
    ("c1", "c3"),
    ("c2", "c3"),
]

COAUTHOR = [
    ("a1", "b2"),
    ("a2", "b3"),
    ("b1", "c1"),
    ("b2", "c2"),
    ("b3", "c3"),
    ("c1", "d1"),
    ("c2", "d1"),
]

COVERS = {
    "C1": ["a1", "a2", "b1", "b2", "b3"],
    "C2": ["b1", "b2", "b3", "c1", "c2", "c3"],
    "C3": ["c1", "c2", "c3", "d1"],
}

EXPECTED_FULL = {("c1", "c2"), ("b1", "b2"), ("a1", "a2"), ("b2", "b3"), ("c2", "c3")}
EXPECTED_NOMP = {("c1", "c2")}
EXPECTED_SMP = EXPECTED_NOMP | {("b1", "b2")}
EXPECTED_MMP = EXPECTED_FULL


def entities() -> EntityTable:
    return EntityTable(names=list(NAMES), truth=None)


def relations() -> Relations:
    e = np.asarray([[IDX[a], IDX[b]] for a, b in COAUTHOR], dtype=np.int64)
    return Relations(edges={"coauthor": e})


def similar_levels() -> dict[int, int]:
    return {
        int(pairlib.make_gid(IDX[a], IDX[b])): 1 for a, b in SIMILAR
    }


def gid_of(a: str, b: str) -> int:
    return int(pairlib.make_gid(IDX[a], IDX[b]))


def names_of(store: MatchStore) -> set[tuple[str, str]]:
    out = set()
    for g in store.gids:
        a, b = pairlib.split_gid(np.int64(g))
        out.add((NAMES[int(a)], NAMES[int(b)]))
    return out


def _make_neighborhood(member_names: list[str], k: int) -> dict:
    ids = np.full(k, -1, dtype=np.int64)
    members = np.asarray([IDX[n] for n in member_names], dtype=np.int64)
    ids[: len(members)] = members
    emask = ids >= 0
    co = np.zeros((k, k), dtype=bool)
    co_set = {(IDX[a], IDX[b]) for a, b in COAUTHOR}
    for i in range(len(members)):
        for j in range(len(members)):
            a, b = int(ids[i]), int(ids[j])
            if (a, b) in co_set or (b, a) in co_set:
                co[i, j] = True
    P = pairlib.num_pairs(k)
    ii, jj = pairlib.triu_indices(k)
    lev = np.zeros(P, dtype=np.int8)
    gid = np.full(P, -1, dtype=np.int64)
    pmask = np.zeros(P, dtype=bool)
    levels = similar_levels()
    for p in range(P):
        i, j = int(ii[p]), int(jj[p])
        if not (emask[i] and emask[j]):
            continue
        g = int(pairlib.make_gid(int(ids[i]), int(ids[j])))
        lv = levels.get(g, 0)
        if lv:
            lev[p] = lv
            gid[p] = g
            pmask[p] = True
    return dict(ids=ids, emask=emask, co=co, lev=lev, gid=gid, pmask=pmask)


def batch_of(neighborhood_names: list[list[str]], k: int = 8) -> NeighborhoodBatch:
    rows = [_make_neighborhood(m, k) for m in neighborhood_names]
    return NeighborhoodBatch(
        entity_ids=np.stack([r["ids"] for r in rows]),
        entity_mask=np.stack([r["emask"] for r in rows]),
        coauthor=np.stack([r["co"] for r in rows]),
        sim_level=np.stack([r["lev"] for r in rows]),
        pair_gid=np.stack([r["gid"] for r in rows]),
        pair_mask=np.stack([r["pmask"] for r in rows]),
    )


def full_batch(k: int = 16) -> NeighborhoodBatch:
    return batch_of([list(NAMES)], k=k)


def packed_cover(k: int = 8) -> PackedCover:
    """The Fig. 2 cover {C1, C2, C3} packed for the drivers."""
    order = ["C1", "C2", "C3"]
    rows = [_make_neighborhood(COVERS[c], k) for c in order]
    nb = NeighborhoodBatch(
        entity_ids=np.stack([r["ids"] for r in rows]),
        entity_mask=np.stack([r["emask"] for r in rows]),
        coauthor=np.stack([r["co"] for r in rows]),
        sim_level=np.stack([r["lev"] for r in rows]),
        pair_gid=np.stack([r["gid"] for r in rows]),
        pair_mask=np.stack([r["pmask"] for r in rows]),
    )
    cover = Cover(
        core=[np.asarray([IDX[n] for n in COVERS[c]], dtype=np.int64) for c in order],
        full=[np.asarray([IDX[n] for n in COVERS[c]], dtype=np.int64) for c in order],
    )
    levels = {}
    for r in rows:
        for g, lv in zip(r["gid"], r["lev"]):
            if g >= 0:
                levels[int(g)] = int(lv)
    return PackedCover(
        bins={k: nb},
        bin_rows={k: np.arange(3, dtype=np.int64)},
        neighborhood_bin=np.full(3, k, dtype=np.int64),
        neighborhood_row=np.arange(3, dtype=np.int64),
        pair_levels=levels,
        cover=cover,
    )
