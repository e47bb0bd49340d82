"""Covering (paper §4): canopies + relational boundary => total cover.

Pipeline (paper-faithful):

1. *Canopies* [McCallum-Nigam-Ungar 2000] over the ``Similar`` relation:
   entities are embedded as hashed n-gram profiles; a seed's canopy is
   every entity with cosine >= ``t_loose``; entities within ``t_tight``
   of the seed stop being seeds.  The seed-vs-pool similarity is the
   ``ngram_sim`` kernel (a tiled product) on the profiles, uploaded to
   the device once per :func:`build_canopies`.
2. *Boundary expansion*: each canopy is expanded with every entity that
   shares a relation tuple (Coauthor) with a member => the cover is
   **total** w.r.t. the relations (Def. 7): no tuple is lost.
3. *Packing*: neighborhoods are padded to fixed entity capacity and
   binned by size (k in ``k_bins``) so the batched matcher runs on
   dense, static shapes.  Size-binning is also our structural answer to
   the MapReduce skew the paper reports in §6.3 (see DESIGN §3).

Oversized canopies are split into overlapping windows (stride k/2) in
similarity-sorted order — the standard blocking trade-off; every split
window is boundary-expanded again, so totality is preserved.

The whole construction is a deterministic function of its inputs: the
same corpus gives the same cover, packed arrays and canopies on any
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import pairs as pairlib
from repro_torch.core import similarity as simlib, txn
from repro_torch.core.types import EntityTable, NeighborhoodBatch, Relations
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.ngram_sim import ops as sim_ops

DEFAULT_BINS = (8, 16, 24, 32)


@dataclasses.dataclass
class Cover:
    """A total cover: per neighborhood, core members and full (core+boundary)."""

    core: list[np.ndarray]
    full: list[np.ndarray]
    _entity_index: dict[int, list[int]] | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def __len__(self) -> int:
        return len(self.full)

    def entity_index(self) -> dict[int, list[int]]:
        """entity id -> neighborhoods (by full membership).

        Memoized: a Cover is immutable once assembled, and the drivers
        consult this index on every evidence-driven re-activation — an
        O(n) rebuild per worklist step without the cache.
        """
        if self._entity_index is None:
            idx: dict[int, list[int]] = {}
            for n, members in enumerate(self.full):
                for e in members:
                    idx.setdefault(int(e), []).append(n)
            self._entity_index = idx
        return self._entity_index


def build_canopies(
    features: np.ndarray,
    t_loose: float,
    t_tight: float,
    *,
    chunk: int = 1024,
    device=None,
) -> list[np.ndarray]:
    """Deterministic canopy construction (seeds in id order).

    The paper picks random seeds; a fixed seed order is a valid draw and
    keeps the construction reproducible.  Order-invariance of the *match
    output* is the framework's consistency property, tested separately.
    Each seed probes the pool chunk by chunk (one ``ngram_sim`` launch a
    chunk) and reads its similarities back once.
    """
    n = features.shape[0]
    feats = torch.as_tensor(np.asarray(features, dtype=np.float32), device=resolve_device(device))
    remaining = np.ones(n, dtype=bool)
    canopies: list[np.ndarray] = []
    order = np.arange(n)
    for seed in order:
        if not remaining[seed]:
            continue
        q = feats[seed : seed + 1]
        blocks = [
            sim_ops.sim_above(q, feats[lo : min(lo + chunk, n)], 0.0)[0]
            for lo in range(0, n, chunk)
        ]
        sims = torch.cat(blocks).cpu().numpy()
        members = np.where(sims >= t_loose)[0]
        if len(members) == 0:
            members = np.array([seed])
        canopies.append(members.astype(np.int64))
        remaining[sims >= t_tight] = False
        remaining[seed] = False
    return canopies


def _split_oversized(members: np.ndarray, names: list[str], k_core: int) -> list[np.ndarray]:
    if len(members) <= k_core:
        return [members]
    order = np.argsort([names[int(e)] for e in members], kind="stable")
    sorted_members = members[order]
    out = []
    step = max(k_core // 2, 1)
    for lo in range(0, len(sorted_members), step):
        win = sorted_members[lo : lo + k_core]
        if len(win) == 0:
            break
        out.append(win)
        if lo + k_core >= len(sorted_members):
            break
    return out


def _expand_part(
    part: np.ndarray, adj: dict[int, set[int]], k_max: int
) -> tuple[np.ndarray, np.ndarray]:
    """Boundary-expand one split part -> (core, full), clipped to k_max."""
    boundary: set[int] = set()
    part_set = set(int(e) for e in part)
    for e in part:
        boundary |= adj.get(int(e), set())
    boundary -= part_set
    # clip boundary to capacity, preferring high-degree connectors
    room = k_max - len(part)
    if len(boundary) > room:
        ranked = sorted(
            boundary,
            key=lambda b: -len(adj.get(b, set()) & part_set),
        )
        boundary = set(ranked[:room])
    full = np.array(sorted(part_set | boundary), dtype=np.int64)
    core = np.asarray(sorted(part_set), dtype=np.int64)
    return core, full


def _pack_edge_groups(missing, k_max: int) -> list[np.ndarray]:
    """Greedily pack uncovered relation edges into supplementary
    neighborhoods (the Def. 7 totality sweep), a pure function of the
    missing-edge set."""
    out: list[np.ndarray] = []
    group: set[int] = set()
    for a, b in sorted(set(missing)):
        if len(group | {a, b}) > k_max:
            out.append(np.asarray(sorted(group), dtype=np.int64))
            group = set()
        group |= {a, b}
    if group:
        out.append(np.asarray(sorted(group), dtype=np.int64))
    return out


def _pack_leftover_chunks(leftovers: list[int], k_max: int) -> list[np.ndarray]:
    """Chunk uncovered entities (sorted) into k_max-sized neighborhoods."""
    return [
        np.asarray(leftovers[lo : lo + k_max], dtype=np.int64)
        for lo in range(0, len(leftovers), k_max)
    ]


def build_cover(
    entities: EntityTable,
    relations: Relations,
    *,
    t_loose: float = 0.70,
    t_tight: float = 0.90,
    k_max: int = 32,
    feature_dim: int = 128,
    boundary_relation: str = "coauthor",
    device=None,
) -> Cover:
    """Canopies on ``device`` (``None`` means CUDA), then host assembly."""
    if entities.features is None:
        entities.features = simlib.ngram_profiles(
            [simlib.block_key(n) for n in entities.names], dim=feature_dim
        )
    canopies = build_canopies(entities.features, t_loose, t_tight, device=device)
    return assemble_cover(
        canopies,
        entities,
        relations,
        k_max=k_max,
        boundary_relation=boundary_relation,
    )


def assemble_cover(
    canopies: list[np.ndarray],
    entities: EntityTable,
    relations: Relations,
    *,
    k_max: int = 32,
    boundary_relation: str = "coauthor",
    present: set[int] | None = None,
) -> Cover:
    """Deterministic canopies -> total cover assembly (split + boundary +
    totality sweep + leftovers).

    Given the *same* canopies in the same order it produces the identical
    Cover.  ``present`` restricts the entity-coverage sweep to ids that
    actually exist (a corpus with holes in its id space).
    """
    adj = relations.adjacency_sets(boundary_relation)
    core_sets: list[np.ndarray] = []
    full_sets: list[np.ndarray] = []
    seen: set[tuple] = set()
    # reserve boundary room: boundary can add up to k_max - k_core slots
    k_core = max(2, int(k_max * 0.6))
    for members in canopies:
        for part in _split_oversized(members, entities.names, k_core):
            key = tuple(sorted(int(e) for e in part))
            if key in seen or len(part) < 2:
                continue
            seen.add(key)
            core, full = _expand_part(part, adj, k_max)
            core_sets.append(core)
            full_sets.append(full)

    # Totality sweep (Def. 7): boundary clipping above can drop relation
    # tuples, and canopy singletons never enter a neighborhood.  Gather
    # every uncovered relation edge and pack the endpoints into
    # supplementary neighborhoods so that R(E) = U R(C_i) exactly.
    covered_edges: set[tuple[int, int]] = set()
    for members in full_sets:
        ms = [int(e) for e in members]
        mset = set(ms)
        for e in ms:
            for nb in adj.get(e, set()):
                if nb in mset:
                    covered_edges.add((min(e, nb), max(e, nb)))
    missing: list[tuple[int, int]] = []
    for edges in relations.edges.values():
        for a, b in edges:
            a, b = int(a), int(b)
            if a != b and (min(a, b), max(a, b)) not in covered_edges:
                missing.append((min(a, b), max(a, b)))
    for arr in _pack_edge_groups(missing, k_max):
        core_sets.append(arr)
        full_sets.append(arr)

    # Entity coverage (cover definition: union of neighborhoods == E):
    # canopy singletons with no relation edges still need a home.
    covered_entities: set[int] = set()
    for members in full_sets:
        covered_entities.update(int(e) for e in members)
    universe = set(range(len(entities))) if present is None else set(present)
    leftovers = sorted(universe - covered_entities)
    for arr in _pack_leftover_chunks(leftovers, k_max):
        core_sets.append(arr)
        full_sets.append(arr)
    return Cover(core=core_sets, full=full_sets)


def is_total(cover: Cover, relations: Relations, candidate_gids: np.ndarray) -> bool:
    """Check Def. 7 (relations) + blocking totality over candidate pairs."""
    covered = set()
    for members in cover.full:
        ms = set(int(e) for e in members)
        for a in ms:
            for b in ms:
                if a < b:
                    covered.add(int(pairlib.make_gid(a, b)))
    for edges in relations.edges.values():
        for a, b in edges:
            if a == b:
                continue
            if int(pairlib.make_gid(int(a), int(b))) not in covered:
                return False
    return all(int(g) in covered for g in candidate_gids)


# ---------------------------------------------------------------------------
# Packing into padded, size-binned NeighborhoodBatches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedCover:
    """Size-binned padded tensors + host-side indices for message passing."""

    bins: dict[int, NeighborhoodBatch]  # k -> batch over neighborhoods
    bin_rows: dict[int, np.ndarray]  # k -> neighborhood index per row
    neighborhood_bin: np.ndarray  # (N,) bin k of each neighborhood
    neighborhood_row: np.ndarray  # (N,) row within its bin
    pair_levels: dict[int, int]  # global gid -> sim level (>=1)
    cover: Cover
    # per-neighborhood row keys (bin, members, intra-relation edges) —
    # populated when packing with a row_cache.
    row_keys: list[tuple] | None = None
    # incidence lookup kept by an incremental packer: (gid -> {row key:
    # refcount}, entity -> {row key: refcount}, row key -> neighborhood
    # positions).  When absent (batch path), queries fall back to the
    # lazily built CSR / entity index below.
    slot_lookup: tuple[dict, dict, dict] | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # memoized slot-incidence CSR (gid -> neighborhoods), see
    # slot_incidence(); a PackedCover is immutable once built.
    _slot_csr: tuple[np.ndarray, np.ndarray, np.ndarray] | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def num_neighborhoods(self) -> int:
        return len(self.neighborhood_bin)

    def rows_for(self, neighborhoods: list[int]) -> dict[int, np.ndarray]:
        """Group a set of neighborhood ids by bin -> row arrays."""
        out: dict[int, list[int]] = {}
        for n in neighborhoods:
            out.setdefault(int(self.neighborhood_bin[n]), []).append(
                int(self.neighborhood_row[n])
            )
        return {k: np.asarray(v, dtype=np.int64) for k, v in out.items()}

    def _positions_of_entity(self, e: int) -> set[int]:
        """Neighborhood positions whose full membership holds ``e``
        (splice-lookup path; callers guard on ``slot_lookup``)."""
        _, ent_rows, pos = self.slot_lookup
        out: set[int] = set()
        for rk in ent_rows.get(int(e), ()):
            out.update(pos.get(rk, ()))
        return out

    def neighborhoods_of_entities(self, ids) -> set[int]:
        """Neighborhoods whose full membership contains any of ``ids``.

        Resolved per query from the splice-maintained lookup when
        present (no per-ingest index rebuild); falls back to the
        memoized ``Cover.entity_index`` on the batch path.
        """
        out: set[int] = set()
        if self.slot_lookup is not None:
            for e in ids:
                out |= self._positions_of_entity(int(e))
            return out
        idx = self.cover.entity_index()
        for e in ids:
            out.update(idx.get(int(e), ()))
        return out

    def neighborhoods_of_pairs(self, gids: np.ndarray) -> list[int]:
        """Neighborhoods containing BOTH endpoints of any of the pairs."""
        if self.slot_lookup is not None:
            out: set[int] = set()
            for g in gids:
                a, b = pairlib.split_gid(np.int64(g))
                out |= self._positions_of_entity(int(a)) & \
                    self._positions_of_entity(int(b))
            return sorted(out)
        idx = self.cover.entity_index()
        out = set()
        for g in gids:
            a, b = pairlib.split_gid(np.int64(g))
            na = idx.get(int(a), [])
            nb = set(idx.get(int(b), []))
            for n in na:
                if n in nb:
                    out.add(n)
        return sorted(out)

    def slot_incidence(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR incidence: candidate pair gid -> neighborhoods holding it
        as a *candidate slot* (``pair_mask`` true).

        Returns ``(gids, indptr, nbhd)``: sorted unique gids, and for
        gid ``gids[i]`` the neighborhoods ``nbhd[indptr[i]:indptr[i+1]]``.
        This is the structure the round-parallel driver re-activates
        from: it is a subset of :meth:`neighborhoods_of_pairs`
        (endpoint incidence), and the difference is inert — a
        neighborhood holding both endpoints but not the candidate slot
        projects no evidence from that pair, so re-evaluating it can
        produce nothing new (its fixpoint contribution is unchanged).
        Built vectorized from the packed bins and memoized.
        """
        if self._slot_csr is None:
            gid_parts: list[np.ndarray] = []
            nb_parts: list[np.ndarray] = []
            for k, nb in self.bins.items():
                mask = nb.pair_mask & (nb.pair_gid >= 0)
                rows, _ = np.nonzero(mask)
                gid_parts.append(nb.pair_gid[mask])
                nb_parts.append(self.bin_rows[k][rows])
            if gid_parts:
                flat_gid = np.concatenate(gid_parts)
                flat_nb = np.concatenate(nb_parts)
                order = np.argsort(flat_gid, kind="stable")
                flat_gid, flat_nb = flat_gid[order], flat_nb[order]
                uniq, starts = np.unique(flat_gid, return_index=True)
                indptr = np.append(starts, len(flat_gid))
            else:
                uniq = np.zeros(0, dtype=np.int64)
                indptr = np.zeros(1, dtype=np.int64)
                flat_nb = np.zeros(0, dtype=np.int64)
            self._slot_csr = (uniq, indptr, flat_nb)
        return self._slot_csr

    def neighborhoods_of_slot_pairs(self, gids: np.ndarray) -> list[int]:
        """Neighborhoods with any of ``gids`` as a candidate slot (sorted).

        With a splice-maintained ``slot_lookup`` (streaming path) this
        resolves per query — gid -> row keys -> positions — without ever
        materializing the O(total candidate slots) CSR; rows with equal
        keys hold identical tensors, so their positions carry exactly
        the queried slot.
        """
        if self.slot_lookup is not None:
            gid_rows, _, pos = self.slot_lookup
            out: set[int] = set()
            for g in gids:
                for rk in gid_rows.get(int(g), ()):
                    out.update(pos.get(rk, ()))
            return sorted(out)
        uniq, indptr, nbhd = self.slot_incidence()
        if not len(gids) or not len(uniq):
            return []
        g = np.asarray(gids, dtype=np.int64)
        pos = np.searchsorted(uniq, g)
        pos = np.clip(pos, 0, len(uniq) - 1)
        pos = pos[uniq[pos] == g]
        if not len(pos):
            return []
        hits = np.concatenate([nbhd[indptr[i] : indptr[i + 1]] for i in pos])
        return [int(n) for n in np.unique(hits)]


def _bin_of(size: int, k_bins: tuple[int, ...]) -> int:
    return next((kb for kb in k_bins if size <= kb), k_bins[-1])


def _pair_level_fn(names: list[str], thresholds, level_cache: dict[int, int]):
    """Host-side Jaro-Winkler discretization, memoized per global pair.

    Levels are name-static, so a cached entry can never go stale.
    """

    def pair_level(a: int, b: int) -> int:
        gid = int(pairlib.make_gid(a, b))
        lev = level_cache.get(gid)
        if lev is None:
            s = simlib.jaro_winkler(simlib.name_key(names[a]), simlib.name_key(names[b]))
            lev = int(simlib.discretize(np.asarray([s]), thresholds)[0])
            if lev == 0 and simlib.abbrev_compatible(names[a], names[b]):
                lev = 1  # abbreviation-aware weak candidate
            elif lev > 0 and simlib.first_name_conflict(names[a], names[b]):
                lev = 0  # full first names of different people: veto
            t = txn.active()
            if t is not None:
                # gids index into `names`: an aborted ingest's entry could
                # otherwise resolve to a *different* name pair after the
                # ids are reused, caching a wrong level forever
                t.save_key(level_cache, gid)
            level_cache[gid] = lev
        return lev

    return pair_level


def _row_key(members: np.ndarray, k: int, adj: dict[int, set[int]]) -> tuple:
    """``(k, members, intra-relation edges)`` — changes whenever anything
    that feeds the staged row tensors changes, so a cached row keyed by
    it can never be reused stale."""
    mkey = tuple(int(e) for e in members[:k])
    intra = tuple(
        (a, b)
        for ai, a in enumerate(mkey)
        for b in mkey[ai + 1 :]
        if b in adj.get(a, set())
    )
    return (k, mkey, intra)


def _stage_row(
    members: np.ndarray, k: int, adj: dict[int, set[int]], pair_level
) -> dict:
    """Stage one neighborhood's padded row tensors (the per-row work of
    :func:`pack_cover`)."""
    members = members[:k]  # safety clip (build_cover respects k_max)
    P = pairlib.num_pairs(k)
    ii, jj = pairlib.triu_indices(k)

    ids = np.full(k, -1, dtype=np.int64)
    ids[: len(members)] = members
    emask = ids >= 0
    co = np.zeros((k, k), dtype=bool)
    for a_slot in range(len(members)):
        a = int(members[a_slot])
        nbrs = adj.get(a, set())
        for b_slot in range(a_slot + 1, len(members)):
            if int(members[b_slot]) in nbrs:
                co[a_slot, b_slot] = True
                co[b_slot, a_slot] = True

    lev = np.zeros(P, dtype=np.int8)
    gid = np.full(P, -1, dtype=np.int64)
    pmask = np.zeros(P, dtype=bool)
    for p in range(P):
        i, j = int(ii[p]), int(jj[p])
        if not (emask[i] and emask[j]):
            continue
        a, b = int(ids[i]), int(ids[j])
        lv = pair_level(a, b)
        if lv >= 1:
            lev[p] = lv
            gid[p] = pairlib.make_gid(a, b)
            pmask[p] = True
    return dict(ids=ids, emask=emask, co=co, lev=lev, gid=gid, pmask=pmask)


def _stack_rows(rows: list[dict]) -> NeighborhoodBatch:
    return NeighborhoodBatch(
        entity_ids=np.stack([r["ids"] for r in rows]),
        entity_mask=np.stack([r["emask"] for r in rows]),
        coauthor=np.stack([r["co"] for r in rows]),
        sim_level=np.stack([r["lev"] for r in rows]),
        pair_gid=np.stack([r["gid"] for r in rows]),
        pair_mask=np.stack([r["pmask"] for r in rows]),
    )


def pack_cover(
    cover: Cover,
    entities: EntityTable,
    relations: Relations,
    *,
    k_bins: tuple[int, ...] = DEFAULT_BINS,
    thresholds=simlib.DEFAULT_THRESHOLDS,
    boundary_relation: str = "coauthor",
    level_cache: dict[int, int] | None = None,
    row_cache: dict[tuple, dict] | None = None,
) -> PackedCover:
    """Pack a cover into size-binned padded tensors.

    ``level_cache`` and ``row_cache`` are optional *persistent* caches:
    ``level_cache`` memoizes the host-side Jaro-Winkler discretization
    per global pair, and ``row_cache`` memoizes fully staged
    neighborhood rows keyed by ``(k, members, intra-relation edges)`` — a
    key that changes whenever anything that feeds the row tensors
    changes, so stale entries can never be reused.
    """
    adj = relations.adjacency_sets(boundary_relation)
    if level_cache is None:
        level_cache = {}
    pair_level = _pair_level_fn(entities.names, thresholds, level_cache)

    n_nb = len(cover)
    neighborhood_bin = np.zeros(n_nb, dtype=np.int64)
    neighborhood_row = np.zeros(n_nb, dtype=np.int64)
    staged: dict[int, list[dict]] = {k: [] for k in k_bins}
    row_keys: list[tuple] | None = [] if row_cache is not None else None

    for n, members in enumerate(cover.full):
        k = _bin_of(len(members), k_bins)

        row = None
        row_key = None
        if row_cache is not None:
            row_key = _row_key(members, k, adj)
            row_keys.append(row_key)
            row = row_cache.get(row_key)
        if row is None:
            row = _stage_row(members, k, adj, pair_level)
            if row_cache is not None:
                row_cache[row_key] = row

        neighborhood_bin[n] = k
        neighborhood_row[n] = len(staged[k])
        staged[k].append(row)

    bins: dict[int, NeighborhoodBatch] = {}
    bin_rows: dict[int, np.ndarray] = {}
    for k, rows in staged.items():
        if not rows:
            continue
        bins[k] = _stack_rows(rows)
        bin_rows[k] = np.where(neighborhood_bin == k)[0]

    # pair_levels must reflect pairs co-resident in *this* cover — not the
    # level cache, which on the streaming path persists across covers and
    # would leak retracted candidate pairs into the global grounding.
    pair_levels: dict[int, int] = {}
    for rows in staged.values():
        for r in rows:
            for g, lv in zip(r["gid"][r["pmask"]], r["lev"][r["pmask"]]):
                pair_levels[int(g)] = int(lv)
    return PackedCover(
        bins=bins,
        bin_rows=bin_rows,
        neighborhood_bin=neighborhood_bin,
        neighborhood_row=neighborhood_row,
        pair_levels=pair_levels,
        cover=cover,
        row_keys=row_keys,
    )
